"""Linear SVM: hinge-loss subgradient with L2 regularization.

The data-dependent subgradient ((y.z < 1) ? -y.x : 0) is merged across
threads; the L2 term is model-only, so it is applied after the merge point —
the DSL's flexibility to 'create different learning algorithms ... by
specifying different merge points' (paper §4.3).

Copy of ``repro.algorithms.svm``, which it is held against; the port imports nothing of ``repro``.
"""
from repro_torch.core import dsl as dana


def svm(
    n_features: int,
    lr: float = 0.05,
    lam: float = 1e-4,
    merge_coef: int = 8,
    conv_factor: float | None = None,
    epochs: int = 20,
):
    # the coefficient vector partitions over the mesh's model axis for wide
    # feature spaces (engine/solver shard_model=True)
    mo = dana.model([n_features], axes=("features",))
    inp = dana.input([n_features])
    out = dana.output()  # labels in {-1, +1}
    mu = dana.meta(lr)
    reg = dana.meta(lam)

    svm_algo = dana.algo(mo, inp, out)
    z = dana.sigma(mo * inp, 1)
    margin = out * z
    viol = margin < 1.0  # 1.0 when the hinge is active
    grad = (0.0 - viol) * out * inp  # -y.x on violation, else 0
    grad = svm_algo.merge(grad, merge_coef, "+")
    # post-merge: average data term + L2 regularization
    full_grad = grad / merge_coef + reg * mo
    mo_up = mo - mu * full_grad
    svm_algo.setModel(mo_up)

    if conv_factor is not None:
        n = dana.norm(grad / merge_coef)
        svm_algo.setConvergence(n < dana.meta(conv_factor))
    svm_algo.setEpochs(epochs)
    return svm_algo
