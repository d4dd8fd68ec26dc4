"""The JAX GPT's prefill and teacher-forced decode steps under
``jax.jit``, the reference of the port's cached-decode tests: XLA
compiles the prefill and one decode step instead of each op, and the
logits are those of the eager calls (within 1.2e-7 at test-tiny)."""
import functools

import jax
import numpy as np

import paddle_tpu as paddle
from paddle_tpu.jit.api import functional_call


def prefill_and_decode(jm, ids, prompt_len, forced, cache_max_len):
    """The logits of the prefill of ``ids`` (right-padded, ragged by
    ``prompt_len``), then of each row of ``forced`` fed as one decode
    step, as numpy arrays; and the cache after the last step."""
    state = {k: v._data for k, v in jm.state_dict().items()}

    @functools.partial(jax.jit, static_argnums=3)
    def prefill(st, x, plen, max_len):
        logits, cache = functional_call(
            jm, st, paddle.Tensor(x), use_cache=True,
            prompt_len=paddle.Tensor(plen), cache_max_len=max_len)
        return logits._data, cache

    @jax.jit
    def step(st, x, cache):
        logits, cache = functional_call(jm, st, paddle.Tensor(x),
                                        cache=cache)
        return logits._data, cache

    logits, cache = prefill(state, np.asarray(ids, np.int32),
                            np.asarray(prompt_len, np.int32), cache_max_len)
    out = [np.asarray(logits)]
    for tok in forced:
        logits, cache = step(state, np.asarray(tok, np.int32)[:, None],
                             cache)
        out.append(np.asarray(logits))
    return out, cache
