"""Linear regression with gradient descent — the paper's §4.3 example, verbatim
in structure: data declarations, gradient of the loss, optimizer, merge,
convergence.

Copy of ``repro.algorithms.linear_regression``, which it is held against; the port imports nothing of ``repro``.
"""
from repro_torch.core import dsl as dana


def linear_regression(
    n_features: int,
    lr: float = 0.05,
    merge_coef: int = 8,
    conv_factor: float | None = None,
    epochs: int = 20,
):
    # the coefficient vector partitions over the mesh's model axis for wide
    # feature spaces (engine/solver shard_model=True)
    mo = dana.model([n_features], axes=("features",))
    inp = dana.input([n_features])
    out = dana.output()
    mu = dana.meta(lr)

    linearR = dana.algo(mo, inp, out)
    # gradient (derivative of the squared loss)
    s = dana.sigma(mo * inp, 1)
    er = s - out
    grad = er * inp
    grad = linearR.merge(grad, merge_coef, "+")
    # gradient descent optimizer (merged gradient averaged over the batch)
    up = mu * (grad / merge_coef)
    mo_up = mo - up
    linearR.setModel(mo_up)

    if conv_factor is not None:
        n = dana.norm(grad / merge_coef)
        linearR.setConvergence(n < dana.meta(conv_factor))
    linearR.setEpochs(epochs)
    return linearR
