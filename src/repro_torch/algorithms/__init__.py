"""Paper workloads expressed in DAnA's DSL (Table 3 algorithms).

Copy of ``repro.algorithms``, which it is held against; the port imports nothing of ``repro``.
"""
from repro_torch.algorithms.linear_regression import linear_regression
from repro_torch.algorithms.logistic_regression import logistic_regression
from repro_torch.algorithms.svm import svm
from repro_torch.algorithms.lrmf import lrmf

ALGORITHMS = {
    "linear": linear_regression,
    "logistic": logistic_regression,
    "svm": svm,
    "lrmf": lrmf,
}

__all__ = ["linear_regression", "logistic_regression", "svm", "lrmf", "ALGORITHMS"]
