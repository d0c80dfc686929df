"""LM training on a (4 data x 2 model) mesh of 8 gloo ranks for
the hybrid, enc-dec and VLM families (hymba-1.5b, seamless-m4t-medium,
internvl2-26b), reduced: two steps each (``test_torch_dist_util``'s
``train_families`` case), held against the unsharded port and against
``repro``'s unsharded steps from the same weights and batches. Each
``test_torch_train_mesh_*.py`` file of families spawns its own ranks, so
that each stays within its time."""
import pytest

import test_torch_train_mesh as train_mesh

FAMILIES = ("hymba-1.5b", "seamless-m4t-medium", "internvl2-26b")


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return train_mesh.train_families(FAMILIES, str(tmp_path_factory.mktemp("families")))


@pytest.mark.parametrize("arch", FAMILIES)
def test_8_ranks_train_every_family(families, arch):
    train_mesh.check_family(families, arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_8_ranks_train_every_family_as_repro(families, arch):
    train_mesh.check_family_as_repro(families, arch)
