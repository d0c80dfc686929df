"""Logistic regression: sigmoid hypothesis, cross-entropy gradient.

Copy of ``repro.algorithms.logistic_regression``, which it is held against; the port imports nothing of ``repro``.
"""
from repro_torch.core import dsl as dana


def logistic_regression(
    n_features: int,
    lr: float = 0.1,
    merge_coef: int = 8,
    conv_factor: float | None = None,
    epochs: int = 20,
):
    # the coefficient vector partitions over the mesh's model axis for wide
    # feature spaces (engine/solver shard_model=True)
    mo = dana.model([n_features], axes=("features",))
    inp = dana.input([n_features])
    out = dana.output()  # labels in {0, 1}
    mu = dana.meta(lr)

    logit = dana.algo(mo, inp, out)
    z = dana.sigma(mo * inp, 1)
    p = dana.sigmoid(z)
    er = p - out
    grad = er * inp
    grad = logit.merge(grad, merge_coef, "+")
    mo_up = mo - mu * (grad / merge_coef)
    logit.setModel(mo_up)

    if conv_factor is not None:
        n = dana.norm(grad / merge_coef)
        logit.setConvergence(n < dana.meta(conv_factor))
    logit.setEpochs(epochs)
    return logit
