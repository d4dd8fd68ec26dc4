"""AnalysisPredictor analog (the JAX package's ``inference/predictor.py``):
a predictor over a live module, with ZeroCopy-style feed and fetch
handles and a bucketed generation mode.

``run()`` serves ``Config.from_layer``'s module under the config's
precision (``inference.precision.serving_params``: bf16/fp16 casts, int8
and int4 weight-only layers, int8 compute), eagerly on the config's
device. Outputs come back to the host as numpy; bf16 has no numpy dtype
here (no ``ml_dtypes``), so a bf16 output is widened exactly to float32
where the JAX package hands back an ``ml_dtypes`` bfloat16 array
(ROADMAP C15: equal values, another dtype).

Generation mode (``Config.enable_generation``) serves the module at its
own dtype (the config's precision applies to ``run()`` only, as in the
JAX package) through one ``GenerationSession``: every prompt bucket that
fits the position table (with the speculative overhang) gets its
(prefill, decode) pair warmed at build (``aot_compile``: every kernel
library loaded, each program run once on scratch state), so serving
builds nothing. Requests are right-padded to the smallest bucket,
short batches padded with dummy rows to the fixed batch, oversized
request lists chunked, and each stream truncated before its first eos.

The JAX package's artifact sources (``.pdmodel``, ``.stablehlo``) are
JAX formats: a missing prefix raises FileNotFoundError as there, an
existing one NotImplementedError naming ROADMAP A9. The static audits
(``audit_generation``, ``audit_forward``) are ROADMAP A12.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import device as device_mod
from .config import Config

__all__ = ["InferTensor", "Predictor", "create_predictor"]


def _to_host(t) -> np.ndarray:
    """A fetched tensor as numpy: bf16 widened exactly to float32."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _leaves(out) -> List[torch.Tensor]:
    """The tensors of a module's output, in order (tuples, lists and
    dicts flattened)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


class InferTensor:
    """ZeroCopyTensor analog: a named feed or fetch slot on a predictor."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray) -> None:
        if not self._is_input:
            raise RuntimeError(f"{self.name} is an output handle")
        self._owner._feeds[self.name] = torch.as_tensor(
            np.asarray(arr), device=self._owner.device)

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise RuntimeError(f"{self.name} is an input handle")
        out = self._owner._outputs.get(self.name)
        if out is None:
            raise RuntimeError("run() the predictor first")
        return _to_host(out)

    def share_external_data(self, arr) -> None:
        """Feed an existing tensor without a host copy (moved to the
        predictor's device when it lies elsewhere)."""
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(np.asarray(arr))
        self._owner._feeds[self.name] = arr.to(self._owner.device)

    @property
    def shape(self):
        src = self._owner._feeds if self._is_input else self._owner._outputs
        val = src.get(self.name)
        return None if val is None else tuple(val.shape)


class Predictor:
    def __init__(self, config: Config):
        self.config = config
        self._feeds: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._gen_session = None
        if config._layer is not None:
            self._build_from_layer()
        elif config._model_prefix is not None:
            self._build_from_artifact()
        else:
            raise ValueError("Config names neither a saved model nor a "
                             "live layer")
        if config._generation is not None:
            self._build_generation()

    # ----------------------------------------------------------- sources
    def _build_from_artifact(self) -> None:
        prefix = self.config._model_prefix
        found = [prefix + ext for ext in (".pdmodel", ".stablehlo")
                 if os.path.exists(prefix + ext)]
        if not found:
            raise FileNotFoundError(
                f"no {prefix}.pdmodel or {prefix}.stablehlo")
        raise NotImplementedError(
            f"{found[0]} is a JAX artifact; loading saved programs is not "
            "ported yet (ROADMAP A9). Serve a live module with "
            "Config.from_layer(...)")

    def _build_from_layer(self) -> None:
        from .precision import serving_params
        sp = serving_params(self.config._layer, self.config)
        self._serving_params = sp
        self.device = sp.device
        spec = self.config._input_spec
        n_in = 1 if spec is None else len(spec)
        self._input_names = [f"x{i}" for i in range(n_in)]
        self._output_names = None

    def _run_fn(self, feeds: List[torch.Tensor]) -> List[torch.Tensor]:
        """The served module on ``feeds`` (float feeds cast to the
        compute dtype); its output tensors in order."""
        sp = self._serving_params
        with torch.no_grad():
            out = sp.layer(*[sp.cast_feed(f) for f in feeds])
        return _leaves(out)

    # -------------------------------------------------------- generation
    def _build_generation(self) -> None:
        """Generation mode: one GenerationSession over the live module at
        its own dtype on the config's device, each bucket's pair (and
        the speculative pair) warmed."""
        from ..generation.api import (GenerationConfig, GenerationSession,
                                      _round_up)
        from ..generation.kv_cache import resolve_cache_dtype
        from ..generation.speculative import as_spec_config
        layer = self.config._layer
        if layer is None:
            raise ValueError("generation mode needs a live layer: use "
                             "Config.from_layer(...) before "
                             "enable_generation()")
        opts = self.config._generation
        self._gen_opts = opts
        self._gen_cfg = GenerationConfig(
            do_sample=opts["do_sample"], temperature=opts["temperature"],
            top_k=opts["top_k"], top_p=opts["top_p"],
            eos_token_id=opts["eos_token_id"],
            pad_token_id=opts["pad_token_id"])
        self._gen_spec = as_spec_config(opts.get("speculative"),
                                        opts.get("draft_model"))
        # the verify window needs k positions past prompt + max_new
        overhang = self._gen_spec.k if self._gen_spec is not None else 0
        max_new = opts["max_new_tokens"]
        max_pos = getattr(getattr(layer, "cfg", None),
                          "max_position_embeddings", None)
        buckets = [b for b in opts["prefill_buckets"]
                   if max_pos is None
                   or b + max_new + overhang <= int(max_pos)]
        if not buckets:
            raise ValueError(
                f"no prefill bucket in {opts['prefill_buckets']} fits "
                f"max_position_embeddings={max_pos} with "
                f"max_new_tokens={max_new}"
                + (f" + speculative overhang {overhang}" if overhang
                   else ""))
        self._gen_buckets = buckets
        # the bucket -> cache length the pairs were warmed with;
        # generate() reads this, never re-derives it
        self._gen_cache_lens = {b: _round_up(b + max_new + overhang)
                                for b in buckets}
        self._gen_cache_dtype = resolve_cache_dtype(
            opts.get("kv_cache_dtype"))
        dev = device_mod.resolve(self.config.device)
        net = layer
        if any(t.device != dev for t in
               list(layer.parameters()) + list(layer.buffers())):
            net = copy.deepcopy(layer).to(device=dev)
        self._gen_network = net
        self._gen_session = GenerationSession(
            net, cache_dtype=self._gen_cache_dtype)
        for b in buckets:
            self._gen_session.aot_compile(opts["max_batch"], b,
                                          self._gen_cache_lens[b],
                                          self._gen_cfg)
        if self._gen_spec is not None:
            spec_sess = self._gen_session.speculative(
                self._gen_spec, opts.get("draft_model"))
            for b in buckets:
                spec_sess.aot_compile(opts["max_batch"], b,
                                      self._gen_cache_lens[b], max_new,
                                      self._gen_cfg)

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 seed: Optional[int] = None) -> List[np.ndarray]:
        """Serve token-id prompts (a list of sequences, or a 2-D array)
        through the warmed buckets: right-padded to the smallest bucket
        that holds the longest prompt of a chunk, short chunks padded
        with dummy rows to the fixed batch, request lists longer than the
        batch chunked. Returns one 1-D int32 array of generated ids per
        prompt, truncated before the first eos when ``eos_token_id`` is
        configured."""
        if self._gen_session is None:
            raise RuntimeError("generation mode not enabled; call "
                               "Config.enable_generation() before "
                               "create_predictor")
        from ..generation.api import generate as _generate
        opts = self._gen_opts
        if max_new_tokens is None:
            max_new_tokens = opts["max_new_tokens"]
        if max_new_tokens > opts["max_new_tokens"]:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the warmed "
                f"budget {opts['max_new_tokens']} (set a larger value "
                "in enable_generation())")
        rows = [np.asarray(p).reshape(-1).astype(np.int64)
                for p in (prompts if not hasattr(prompts, "ndim")
                          else list(prompts))]
        if any(r.size < 1 for r in rows):
            raise ValueError("empty prompt")
        max_batch = opts["max_batch"]
        cfg = self._gen_cfg
        eos = cfg.eos_token_id
        results: List[np.ndarray] = []
        for lo in range(0, len(rows), max_batch):
            chunk = rows[lo:lo + max_batch]
            longest = max(r.size for r in chunk)
            bucket = next((b for b in self._gen_buckets if b >= longest),
                          None)
            if bucket is None:
                raise ValueError(
                    f"prompt of {longest} tokens exceeds the largest "
                    f"warmed prefill bucket {self._gen_buckets[-1]}")
            ids = np.full((max_batch, bucket), cfg.pad_value, np.int64)
            plen = np.ones((max_batch,), np.int64)  # dummy rows: len 1
            for i, r in enumerate(chunk):
                ids[i, :r.size] = r
                plen[i] = r.size
            out = _generate(
                self._gen_network, ids, max_new_tokens=max_new_tokens,
                prompt_len=plen, cache_max_len=self._gen_cache_lens[bucket],
                seed=seed, session=self._gen_session,
                live_rows=len(chunk),
                do_sample=cfg.do_sample, temperature=cfg.temperature,
                top_k=cfg.top_k, top_p=cfg.top_p, eos_token_id=eos,
                pad_token_id=cfg.pad_token_id,
                speculative=self._gen_spec,
                draft_model=opts.get("draft_model"))
            for row in out.cpu().numpy()[:len(chunk)]:
                if eos is not None:
                    hits = np.nonzero(row == eos)[0]
                    if hits.size:
                        row = row[:hits[0]]
                results.append(row.astype(np.int32))
        return results

    # ------------------------------------------------------------- audit
    def audit_generation(self, **audit_kw):
        raise NotImplementedError(
            "audit_generation is not ported yet (ROADMAP A12: the static "
            "analysis on torch.fx / torch.export graphs)")

    def audit_forward(self, **audit_kw):
        raise NotImplementedError(
            "audit_forward is not ported yet (ROADMAP A12: the static "
            "analysis on torch.fx / torch.export graphs)")

    # --------------------------------------------------------------- api
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> InferTensor:
        if name not in self._input_names:
            raise KeyError(f"unknown input {name!r}; "
                           f"have {self._input_names}")
        return InferTensor(name, self, is_input=True)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """ZeroCopyRun analog over the handles' feeds; with ``inputs``
        (arrays or tensors, in input order) the newer list API, which
        returns the outputs as numpy (bf16 widened to float32)."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._feeds[n] = a.to(self.device) \
                    if isinstance(a, torch.Tensor) \
                    else torch.as_tensor(np.asarray(a), device=self.device)
        missing = [n for n in self._input_names if n not in self._feeds]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        outs = self._run_fn([self._feeds[n] for n in self._input_names])
        if self._output_names is None:
            self._output_names = [f"out{i}" for i in range(len(outs))]
        self._outputs = dict(zip(self._output_names, outs))
        if inputs is not None:
            return [_to_host(o) for o in outs]
        return True

    def get_output_names(self) -> List[str]:
        if self._output_names is None:
            raise RuntimeError("run() the predictor first")
        return list(self._output_names)

    def get_output_handle(self, name: str) -> InferTensor:
        if self._output_names is not None and \
                name not in self._output_names:
            raise KeyError(f"unknown output {name!r}; "
                           f"have {self._output_names}")
        return InferTensor(name, self, is_input=False)

    def clone(self) -> "Predictor":
        """A second session over the same served module (the reference's
        Clone: shares the program and weights, new feeds and fetches)."""
        twin = copy.copy(self)
        twin._feeds, twin._outputs = {}, {}
        return twin


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
