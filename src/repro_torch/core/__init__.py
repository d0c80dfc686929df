"""DAnA core on PyTorch: DSL -> hDFG -> merged, accelerated execution
(counterpart of ``repro.core``)."""
from repro_torch.core import dsl
from repro_torch.core.engine import init_models, make_engine
from repro_torch.core.hdfg import HDFG
from repro_torch.core.translator import trace, translate

__all__ = ["dsl", "trace", "translate", "make_engine", "init_models", "HDFG"]
