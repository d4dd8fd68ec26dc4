"""Tensor-parallel layers (the JAX package's
``distributed/parallel/mp_layers.py``). So far only
``sharded_constraint``, which the models call at the seams where a mesh
would pin an activation's layout: on one card there is no mesh, so it
returns its input. The mesh layers (``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``,
``ParallelCrossEntropy``) are ROADMAP A11."""
from __future__ import annotations


def sharded_constraint(x, spec=None):
    """``x`` unchanged: the layout hint ``spec`` has no mesh to act on."""
    return x
