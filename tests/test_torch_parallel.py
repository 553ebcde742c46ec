"""PyTorch port vs the JAX package: parallel training and sharded inference.

One 4-process ``gloo`` run of ``parallel/dryrun.py`` (spawned once for the
module) from JAX's seeded YOLOv8n (nc 8) on one global batch (B 8, 64 px,
f32): the data-parallel step against JAX's ``make_dp_train_step`` on its
virtual CPU devices, the tensor-parallel and data x spatial steps against
the port's data-parallel one, the dry run's own checks, and
``ShardedDetector`` against one rank and against JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.parallel.inference import ShardedDetector as JaxShardedDetector  # noqa: E402
from manual_yolo_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from manual_yolo_tpu.parallel.trainer import make_dp_train_step as jax_dp_step  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import save_params  # noqa: E402
from manual_yolo_tpu_torch.parallel import dryrun  # noqa: E402
from manual_yolo_tpu_torch.parallel.mesh import _largest_divisor_leq  # noqa: E402
from torch_train_cases import detect_batch  # noqa: E402

N_RANKS, B = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4-rank dry run and JAX's data-parallel step, from the same
    init tree and batch."""
    if len(jax.devices()) < N_RANKS:
        pytest.skip("needs 4 virtual JAX devices (tests/conftest.py)")
    tmp = tmp_path_factory.mktemp("parallel")
    spec = jy.build_spec("detect", "n", dryrun.NC)
    params = jax.tree_util.tree_map(np.asarray, jy.init_params(jax.random.PRNGKey(0), spec))
    x, t, m = detect_batch(B, dryrun.SIZE, 6, dryrun.NC)
    save_params(str(tmp / "init.npz"), params, dtype=None)
    np.savez(tmp / "batch.npz", x=x, t=t, m=m)
    port = dryrun.run(N_RANKS, str(tmp / "init.npz"), str(tmp / "batch.npz"))

    mesh = jax_make_mesh(N_RANKS, axes=("data",))
    tx = optax.adamw(dryrun.LR)
    step = jax_dp_step(spec, tx, mesh, compute_dtype=jnp.float32)
    repl, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    put = jax.device_put
    p, ema, _, loss, aux = step(put(params, repl), put(params, repl), put(tx.init(params), repl),
                                jnp.asarray(0, jnp.int32), put(jnp.asarray(x), bsh),
                                put(jnp.asarray(t), bsh), put(jnp.asarray(m), bsh))
    det = JaxShardedDetector(jy.fold_params(params, spec), spec, mesh, imgsz=dryrun.SIZE,
                             conf=1e-6, compute_dtype=jnp.float32)
    inf = jax.device_get(det(port["inf_frames"]))
    return port, {"loss": float(loss), "num_fg": int(aux["num_fg"]),
                  "params": [np.asarray(a) for a in jax.tree_util.tree_leaves(p)],
                  "ema": [np.asarray(a) for a in jax.tree_util.tree_leaves(ema)], "inf": inf}


def _close(got, ref, what, tol=3e-4, median=3e-5):
    """The card-against-CPU rule of the training tests for a first update
    (``tests/test_torch_gpu.py``), tightened to what these runs show: the median weight within
    ``median``, all but 1e-4 of the weights within ``tol``, every weight
    within 2.2e-3. AdamW's first update is about lr * sign(g), so a gradient
    element within rounding of 0 can move its weight by up to 2 * lr = 2e-3
    either way in two correct implementations."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape, what
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    assert d.max() <= 2.2e-3, (what, d.max())
    assert np.median(d) <= median, (what, np.median(d))
    assert (d > tol).mean() <= 1e-4, (what, (d > tol).mean())


def test_mesh_shape_rule():
    """JAX's rule for two axes: the largest divisor <= sqrt(n) on the second."""
    assert [(n // _largest_divisor_leq(n, int(np.sqrt(n))), _largest_divisor_leq(n, int(np.sqrt(n))))
            for n in (1, 2, 4, 6, 8)] == [(1, 1), (2, 1), (2, 2), (3, 2), (4, 2)]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host with no card")
def test_process_group_defaults_to_the_card(tmp_path):
    """``init_process_group`` takes NCCL for the card unless the caller asks
    for the CPU, so on a host with no card the default raises."""
    from manual_yolo_tpu_torch.parallel import mesh as mesh_lib

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_lib.init_process_group(0, 1, str(tmp_path / "store"))


def test_dryrun_checks_pass(runs, capsys):
    """The JAX dry run's assertions on the port's run: finite first loss,
    eight steps lower it, the restored checkpoint steps bit for bit as the
    live state, TP and data x spatial give the DP loss, sharded inference
    equals one rank with boxes surviving."""
    port, _ = runs
    dryrun.check(port, N_RANKS)
    out = capsys.readouterr().out
    assert "dryrun TP ok" in out and "dryrun 2D ok" in out and "inference ok" in out


def test_dp_step_matches_jax(runs):
    """The 4-rank data-parallel step against JAX's on 4 virtual devices:
    loss within 1e-4 relative, the same foreground count, parameters and EMA
    by that rule (``_close``)."""
    port, ref = runs
    np.testing.assert_allclose(port["dp_losses"][0], ref["loss"], rtol=1e-4)
    assert int(port["dp_num_fg"]) == ref["num_fg"] > 0
    _close(port["dp_params"], ref["params"], "params")
    _close(port["dp_ema"], ref["ema"], "ema")


@pytest.mark.parametrize("layout", ["tp", "sp"])
def test_tensor_and_spatial_steps_match_dp(runs, layout):
    """Tensor parallel on (data 2, model 2) and data x spatial on (data 2,
    spatial 2, 32-row bands) against the port's 4-rank data parallel: loss
    within 1e-4 relative, the updated parameters (and TP's EMA) by
    ``_close`` at 1e-4, the median weight within 1e-7."""
    port, _ = runs
    np.testing.assert_allclose(port[f"{layout}_loss"], port["dp_losses"][0], rtol=1e-4)
    _close(port[f"{layout}_params"], port["dp_params"], layout, tol=1e-4, median=1e-7)
    if layout == "tp":
        _close(port["tp_ema"], port["dp_ema"], "tp ema", tol=1e-4, median=1e-7)


def test_tensor_parallel_shards_half_the_channels(runs):
    """On a model axis of 2, every sharded leaf holds half its out-channels;
    the rest (widths below 16 or not dividing) are whole."""
    port, _ = runs
    assert len(port["tp_shard_ratio"]) > 100
    assert np.all(port["tp_shard_ratio"] == 0.5) and bool(port["tp_replicated_equal"])


def test_sharded_detector_matches_one_rank_and_jax(runs):
    """8 frames over 4 ranks: equal to one rank's program within 1e-4; to
    JAX's ShardedDetector: counts and classes equal, boxes and scores within
    1e-3 (as the pipeline test holds them); boxes survive."""
    port, ref = runs
    for name in ("boxes", "scores", "classes", "count"):
        np.testing.assert_allclose(port[f"inf_{name}"], port[f"inf_ref_{name}"], rtol=0, atol=1e-4)
    assert int(port["inf_count"].sum()) > 0
    inf = ref["inf"]
    np.testing.assert_array_equal(port["inf_count"], inf.count)
    np.testing.assert_array_equal(port["inf_classes"], inf.classes)
    np.testing.assert_allclose(port["inf_scores"], inf.scores, rtol=0, atol=1e-3)
    np.testing.assert_allclose(port["inf_boxes"], inf.boxes, rtol=0, atol=1e-3)
