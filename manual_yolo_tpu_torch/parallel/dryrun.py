"""Multi-process dry run of the parallel paths on the CPU.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``_dryrun_multichip_impl``):
where JAX runs one program over ``n`` virtual CPU devices, this spawns ``n``
processes joined in a ``gloo`` group (a ``FileStore`` in a temporary
directory) and runs the JAX dry run's checks in its order:

  1. one data-parallel detector step (YOLOv8n, 8 classes, 64 px, f32,
     ``adamw`` at 1e-3 with optax's default decay of 1e-4, no clip) has a
     finite loss;
  2. eight chained steps on the same batch lower the loss;
  3. a save -> restore -> step round trip (params, EMA and AdamW state in
     f32) gives the live step's loss and parameters, bit for bit;
  4. (n >= 4) the tensor-parallel step on a (data, model) mesh and
  5. (n >= 4) the data x spatial step on a (data, spatial) mesh give the
     data-parallel first loss (within 1e-4 relative);
  6. sharded inference (``ShardedDetector``, conf 1e-6 so that random-init
     boxes survive) equals one rank's program on the whole batch.

    python -m manual_yolo_tpu_torch.parallel.dryrun --n 4

``run(n)`` returns rank 0's results (losses, parameters after the first
step of each layout, the inference outputs); the tests read them.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NC, SIZE, M = 8, 64, 8
LR, WD = 1e-3, 1e-4  # optax.adamw(1e-3): its default weight decay is 1e-4


def default_batch(b: int, seed: int = 0):
    """The JAX dry run's batch: uniform [0, 1) frames, one box per frame."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, SIZE, SIZE, 3), np.float32)
    t = np.zeros((b, M, 5), np.float32)
    m = np.zeros((b, M), bool)
    t[:, 0] = [1, 4, 4, 40, 40]
    m[:, 0] = True
    return x, t, m, rng


def _flat(tree) -> Dict[str, np.ndarray]:
    from manual_yolo_tpu_torch.train.detector import tree_leaves

    return {f"{i:04d}": np.array(a, copy=True) for i, a in enumerate(tree_leaves(tree))}


def _worker(rank: int, n: int, store: str, out: str, params_npz: Optional[str],
            batch_npz: Optional[str]) -> None:
    from manual_yolo_tpu_torch.core.serialization import load_params, save_params
    from manual_yolo_tpu_torch.models import yolov8
    from manual_yolo_tpu_torch.parallel import mesh as mesh_lib
    from manual_yolo_tpu_torch.parallel import trainer as ptrain
    from manual_yolo_tpu_torch.parallel.inference import ShardedDetector
    from manual_yolo_tpu_torch.train.detector import load_opt_leaves, opt_leaves
    from manual_yolo_tpu_torch.train.optim import adamw, set_lr

    torch.set_num_threads(1)
    mesh_lib.init_process_group(rank, n, store, device="cpu")
    res: Dict[str, np.ndarray] = {}
    spec = yolov8.build_spec("detect", "n", NC)
    if params_npz:
        params, _ = load_params(params_npz, dtype=None)
    else:
        params = yolov8.init_params(torch.Generator().manual_seed(0), spec)
    if batch_npz:
        z = np.load(batch_npz)
        x, t, m = z["x"], z["t"], z["m"]
        rng = np.random.default_rng(1)
    else:
        x, t, m, rng = default_batch(n)
    x, t, m = (torch.from_numpy(a) for a in (x, t, m))

    def fresh():
        model = yolov8.load_jax_params(yolov8.build_model(spec, torch.float32, train=True),
                                       params).train()
        mesh_lib.shard_params(mesh, model)  # rank 0's state on every rank
        opt = adamw(model.parameters(), WD)
        set_lr(opt, LR)
        return model, copy.deepcopy(model), opt

    # 1-2. data parallel: one step, then seven more on the same batch
    mesh = mesh_lib.make_mesh(n, axes=("data",))
    step = ptrain.make_dp_train_step(mesh)
    xs, ts, ms = mesh_lib.shard_batch(mesh, (x, t, m))
    model, ema, opt = fresh()
    losses = []
    for it in range(8):
        loss, aux = step(model, ema, opt, it, xs, ts, ms)
        losses.append(float(loss))
        if it == 0:
            res["dp_params"] = _flat(yolov8.export_params(model))
            res["dp_ema"] = _flat(yolov8.export_params(ema))
            res["dp_num_fg"] = np.asarray(float(aux["num_fg"]))
    res["dp_losses"] = np.asarray(losses)

    # 3. checkpoint round trip
    ck = os.path.join(out, "ck.npz")
    if rank == 0:
        save_params(ck, {"params": yolov8.export_params(model), "ema": yolov8.export_params(ema),
                         "opt": opt_leaves(model, opt)}, dtype=None)
    dist.barrier()
    restored, _ = load_params(ck, dtype=None)
    r_model = yolov8.load_jax_params(yolov8.build_model(spec, torch.float32, train=True),
                                     restored["params"]).train()
    r_ema = yolov8.load_jax_params(yolov8.build_model(spec, torch.float32, train=True),
                                   restored["ema"]).train()
    r_opt = adamw(r_model.parameters(), WD)
    set_lr(r_opt, LR)
    load_opt_leaves(r_model, r_opt, restored["opt"])
    live = step(model, ema, opt, 8, xs, ts, ms)
    resumed = step(r_model, r_ema, r_opt, 8, xs, ts, ms)
    res["ck_losses"] = np.asarray([float(live[0]), float(resumed[0])])
    res["ck_equal"] = np.asarray(all(
        torch.equal(v, r_model.state_dict()[k]) for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked")))

    if n >= 4:
        # 4. tensor parallel on (data, model)
        mesh_tp = mesh_lib.make_mesh(n, axes=("data", "model"))
        step_tp, place = ptrain.make_tp_train_step(mesh_tp)
        model, ema, opt = fresh()
        full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        model, ema, opt, xt, tt, mt = place(model, ema, opt, x, t, m)
        shard = ptrain.channel_shardings(mesh_tp, model)
        res["tp_shard_ratio"] = np.asarray(
            [model.state_dict()[k].shape[0] / full[k][0] for k, s in shard.items() if s])
        res["tp_replicated_equal"] = np.asarray(
            all(model.state_dict()[k].shape == full[k] for k, s in shard.items() if not s))
        loss, _ = step_tp(model, ema, opt, 0, xt, tt, mt)
        res["tp_loss"] = np.asarray(float(loss))
        res["tp_params"] = _flat(yolov8.export_params(ptrain.gather_channels(mesh_tp, model)))
        res["tp_ema"] = _flat(yolov8.export_params(ptrain.gather_channels(mesh_tp, ema)))

        # 5. data x spatial on (data, spatial)
        mesh_sp = mesh_lib.make_mesh(n, axes=("data", "spatial"))
        step_sp = ptrain.make_dp_train_step(mesh_sp, spatial_axis="spatial")
        model, ema, opt = fresh()
        xd, td, md = mesh_lib.shard_batch(mesh_sp, (x, t, m))
        loss, _ = step_sp(model, ema, opt, 0, mesh_lib.shard_spatial(mesh_sp, xd), td, md)
        res["sp_loss"] = np.asarray(float(loss))
        res["sp_params"] = _flat(yolov8.export_params(model))

    # 6. sharded inference against one rank's program
    folded = yolov8.fold_params(params, spec)
    det = ShardedDetector(folded, spec, mesh, imgsz=SIZE, conf=1e-6,
                          compute_dtype=torch.float32, device="cpu")
    frames = rng.integers(0, 255, (2 * n, 96, 128, 3), np.uint8)
    got, ref = det(frames), det.local(frames)
    for name in ("boxes", "scores", "classes", "count"):
        res[f"inf_{name}"] = getattr(got, name).numpy()
        res[f"inf_ref_{name}"] = getattr(ref, name).numpy()
    res["inf_frames"] = frames

    if rank == 0:
        flat = {}
        for k, v in res.items():
            if isinstance(v, dict):
                flat.update({f"{k}/{i}": a for i, a in v.items()})
            else:
                flat[k] = v
        np.savez(os.path.join(out, "results.npz"), **flat)
    dist.barrier()
    dist.destroy_process_group()


def _unflat(z) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k in z.files:
        if "/" in k:
            top, i = k.split("/")
            out.setdefault(top, {})[i] = z[k]
        else:
            out[k] = z[k]
    return {k: ([v[i] for i in sorted(v)] if isinstance(v, dict) else v) for k, v in out.items()}


def run(n: int = 4, params_npz: Optional[str] = None, batch_npz: Optional[str] = None,
        timeout: float = 600.0) -> Dict[str, object]:
    """Spawn ``n`` gloo processes, run the checks' steps, -> rank 0's results."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        cmd = [sys.executable, "-m", "manual_yolo_tpu_torch.parallel.dryrun", "--worker",
               "--n", str(n), "--store", store, "--out", tmp]
        if params_npz:
            cmd += ["--params", params_npz]
        if batch_npz:
            cmd += ["--batch", batch_npz]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(n)]
        outs = []
        deadline = time.time() + timeout
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(f"dry-run ranks failed {bad}:\n" + "\n".join(o[-3000:] for o in outs))
        with np.load(os.path.join(tmp, "results.npz")) as z:
            return _unflat(z)


def check(res: Dict[str, object], n: int) -> None:
    """The JAX dry run's assertions, on ``run``'s results; prints its lines."""
    losses = [float(v) for v in res["dp_losses"]]
    assert np.isfinite(losses[0]), f"non-finite loss {losses[0]}"
    print(f"dryrun ok: {n} ranks, loss {losses[0]:.4f}, fg {int(res['dp_num_fg'])}")
    assert all(np.isfinite(v) for v in losses), f"non-finite losses {losses}"
    assert min(losses[-3:]) < losses[0], f"loss did not decrease over 8 steps: {losses}"
    print(f"dryrun multi-step ok: loss {losses[0]:.4f} -> {losses[-1]:.4f} over 8 sharded steps")
    live, resumed = (float(v) for v in res["ck_losses"])
    assert live == resumed and bool(res["ck_equal"]), f"restored step {resumed} != live {live}"
    print(f"dryrun checkpoint ok: save->restore->step matches live bit for bit (loss {resumed:.4f})")
    if n >= 4:
        for name, key in (("TP", "tp_loss"), ("2D", "sp_loss")):
            v = float(res[key])
            assert abs(v - losses[0]) <= 1e-4 * abs(losses[0]), f"{name} loss {v} != dp loss {losses[0]}"
            print(f"dryrun {name} ok: loss {v:.6f} (dp {losses[0]:.6f})")
        assert np.all(res["tp_shard_ratio"] == 0.5) and bool(res["tp_replicated_equal"])
    for name in ("boxes", "scores", "classes", "count"):
        a, b = res[f"inf_{name}"], res[f"inf_ref_{name}"]
        assert np.allclose(a, b, atol=1e-4), f"sharded inference {name}: max|d| {np.abs(a - b).max()}"
    counts = res["inf_count"]
    assert int(counts.sum()) > 0, "sharded inference check is vacuous: no boxes survived"
    print(f"dryrun inference ok: {len(counts)} frames over {n} ranks == one rank "
          f"(counts {counts.tolist()})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multi-process dry run of the parallel paths")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    ap.add_argument("--params", default=None, help="JAX-layout init tree (.npz, f32)")
    ap.add_argument("--batch", default=None, help="x, t, m arrays (.npz)")
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.rank, args.n, args.store, args.out, args.params, args.batch)
        return 0
    t0 = time.time()
    check(run(args.n, args.params, args.batch), args.n)
    print(f"dryrun done in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
