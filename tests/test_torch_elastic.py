"""The elastic reshard (``repro_torch.launch.elastic_restart``, the port of
``examples/elastic_restart.py``) against ``repro``: one spawn of 8 gloo
ranks (``test_torch_dist_util``'s ``elastic`` case) trains internlm2-20b
reduced (d_model 64, 4/4 heads) from ``repro``'s own starting weights on a
(4 data x 2 model) mesh, saves, restores with ``shardings=`` onto (2 x 4)
and trains on, while ``repro``'s same flow runs on 8 forced host devices in
a subprocess (as ``tests/test_shard_map_engine.py`` runs its 8-device
cases); and the module's command line on 8 ranks of the CPU."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import test_torch_dist_util as dist_util
from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro_torch.launch import elastic_restart
from test_torch_rwkv import BF16_LOSS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8

# examples/elastic_restart.py's flow, each step's loss recorded
_REPRO_FLOW = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import tempfile

    import jax

    from repro.configs import get_reduced_config
    from repro.data.pipeline import synthetic_data_fn
    from repro.dist import meshes
    from repro.models import model_zoo
    from repro.train import checkpoint as ckpt
    from repro.train.optimizer import OptConfig, adamw_init, make_train_step

    assert jax.device_count() == 8
    tmp = tempfile.mkdtemp(prefix="elastic_")
    cfg = get_reduced_config("internlm2-20b", d_model=64, n_heads=4, n_kv_heads=4)
    params, specs = model_zoo.init_params(cfg, jax.random.PRNGKey(0))
    data_fn = synthetic_data_fn(cfg, batch=8, seq=32)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)
    step_fn = jax.jit(make_train_step(model_zoo.loss_fn(cfg, remat="none"), opt_cfg))

    def place(params, specs, mesh):
        sh = meshes.tree_shardings(specs, params, mesh)
        return jax.tree.map(jax.device_put, params, sh)

    out = {"a": [], "b": []}
    mesh1 = meshes.make_mesh((4, 2), ("data", "model"))
    with meshes.use_mesh(mesh1):
        p = place(params, specs, mesh1)
        opt = adamw_init(p, opt_cfg)
        for s in range(5):
            p, opt, m = step_fn(p, opt, data_fn(s))
            out["a"].append(float(m["loss"]))
        ckpt.save(os.path.join(tmp, "ck"), 5, {"params": p, "opt": opt})
    mesh2 = meshes.make_mesh((2, 4), ("data", "model"))
    with meshes.use_mesh(mesh2):
        template = {"params": params, "opt": adamw_init(params, opt_cfg)}
        param_sh = meshes.tree_shardings(specs, params, mesh2)
        restored, step = ckpt.restore(os.path.join(tmp, "ck"), template)
        p2 = jax.tree.map(jax.device_put, restored["params"], param_sh)
        opt2 = jax.tree.map(jax.numpy.asarray, restored["opt"])
        for s in range(step, step + 5):
            p2, opt2, m2 = step_fn(p2, opt2, data_fn(s))
            out["b"].append(float(m2["loss"]))
    out["step"] = int(opt2["step"])
    print("RESULT " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """repro's starting weights written for the ranks, the 8 ranks started,
    and repro's flow run in its subprocess meanwhile."""
    work = str(tmp_path_factory.mktemp("elastic_8"))
    jcfg = jreduced("internlm2-20b", **elastic_restart.EXAMPLE_WIDTH["internlm2-20b"])
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    torch.save(jax.tree.map(np.asarray, jp), os.path.join(work, "elastic_weights.pt"))
    started = dist_util.start("elastic", WORLD, work)
    try:
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run([sys.executable, "-c", _REPRO_FLOW], env=env,
                              capture_output=True, text=True, timeout=300, cwd=REPO)
    finally:
        ranks = dist_util.collect(started)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return ranks, json.loads(line[len("RESULT "):])


def test_8_ranks_follow_repros_elastic_flow(elastic):
    """Every loss of both meshes at BF16_LOSS from repro's 8-device flow;
    the restored step 5 and the final step 10, on every rank."""
    ranks, want = elastic
    assert want["step"] == 10
    for r in ranks:
        assert r["restored_step"] == 5 and r["step"] == 10
        np.testing.assert_allclose(r["losses"]["a"], want["a"], rtol=BF16_LOSS)
        np.testing.assert_allclose(r["losses"]["b"], want["b"], rtol=BF16_LOSS)
        assert r["losses"] == ranks[0]["losses"]
        assert r["forbidden"] == []
        assert set(r["collectives"]) == {"all_reduce", "broadcast"}
        assert r["barriers"]["barrier"] == 1  # the save's


def test_8_ranks_reshard_onto_the_second_mesh(elastic):
    """After the restore the weights sit on (2 x 4): the vocab rows of the
    embedding on the 4-way model axis, its moments' zero axis on the 2-way
    data axis; every whole leaf the same bits on every rank."""
    ranks, _ = elastic
    r = ranks[0]
    assert r["placements"]["embed/table"] == ["R", "S(0)"]
    assert r["opt_placements"]["mu/embed/table"] == ["S(1)", "S(0)"]
    assert r["opt_placements"]["step"] is None
    first = r["whole"]
    for other in ranks[1:]:
        assert other["whole"].keys() == first.keys()
        for name, v in other["whole"].items():
            assert np.array_equal(v, first[name]), name


def test_command_line_spawns_its_ranks_and_prints_ok(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.elastic_restart", "--ranks", "8",
         "--device", "cpu", "--workdir", str(tmp_path), "--seq", "16", "--steps", "2"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK"
    assert lines[0].startswith("phase 1 on mesh (4 data x 2 model): step 2, loss ")
    assert lines[1].startswith("phase 2 on mesh (2 data x 4 model): resumed at 2, loss ")
    assert os.path.isdir(tmp_path / "ck" / "step_00000002")


def test_command_line_refuses_meshes_that_do_not_fit_the_ranks(tmp_path):
    with pytest.raises(SystemExit, match="need 8 ranks"):
        elastic_restart.main(["--ranks", "8", "--device", "cpu", "--mesh-a", "2x2",
                              "--workdir", str(tmp_path)])
