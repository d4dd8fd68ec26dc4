"""The port's ``ops/math.py`` against the JAX package's, op by op.

Each op the JAX ``ops/math.py`` registers runs through both
registries on the same numpy inputs (``tests/_port_op_parity.py``):
values and dtypes, and the gradient of a differentiable op by each
package's own ``backward``. Tolerances, stated there: bitwise for data
movement, comparisons and arithmetic both do in one order; 1e-6 for
other fp32 values and gradients; 1e-5 for transcendentals, row
reductions and linear algebra.
"""
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import device as port_device

import _port_op_parity as H

NAMES = H.registered_by("math")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_device, "_CURRENT", torch.device("cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    assert name not in H.EXCEPTIONS
    H.compare(name, H.run(paddle_tpu, name, True),
              H.run(paddle_tpu_torch, name, True))
