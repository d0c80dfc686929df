"""Low-rank matrix factorization (Netflix-style).

One training tuple = one user's dense ratings row x (n_items). The model is
the item-factor matrix M (n_items, rank); the user factor is re-encoded per
tuple as u = M'x (projection), making the update rule expressible in the DSL
without per-tuple model indexing (which the hardware — and the DSL — does not
support). The merged gradient is the linear-autoencoder gradient of
||x - M M'x||^2 w.r.t. M with u treated as constant, the standard SGD-LRMF
surrogate used by in-RDBMS implementations.

This workload exercises the DSL's multi-dimensional model support and the
paper's §4.4 outer-replication dimension inference (er [n] * u [r] -> [n, r]).

Copy of ``repro.algorithms.lrmf``, which it is held against; the port imports nothing of ``repro``.
"""
from repro_torch.core import dsl as dana


def lrmf(
    n_items: int,
    rank: int = 10,
    lr: float = 1e-3,
    merge_coef: int = 4,
    conv_factor: float | None = None,
    epochs: int = 20,
):
    # the item dim is the factor matrix's "features" axis: wide catalogs
    # partition it over the mesh's model axis (shard_model=True); the rank
    # dim stays replicated
    M = dana.model([n_items, rank], axes=("features", "rank"))
    row = dana.input([n_items, 1])  # ratings row as a column for broadcasting
    dummy = dana.output()
    mu = dana.meta(lr)

    algo = dana.algo(M, row, dummy)
    u = dana.sigma(M * row, 1)  # user factor: M'x -> (rank,)
    pred = dana.sigma(M * u, 2)  # reconstruction: M u -> (n_items,)
    xv = dana.sigma(row, 2)  # ratings row as a vector -> (n_items,)
    er = pred - xv
    grad = er * u  # outer product -> (n_items, rank)
    grad = algo.merge(grad, merge_coef, "+")
    M_up = M - mu * (grad / merge_coef)
    algo.setModel(M_up)

    if conv_factor is not None:
        n = dana.norm(grad / merge_coef)
        algo.setConvergence(n < dana.meta(conv_factor))
    algo.setEpochs(epochs)
    return algo
