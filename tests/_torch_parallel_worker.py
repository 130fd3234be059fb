"""The ranks of ``tests/test_torch_parallel.py``: one
``torch.multiprocessing.spawn`` of gloo ranks on the CPU runs every
multi-process case of the file in turn. A spawned rank imports this module
only (torch and the port), joins the group through
``parallel.distributed.initialize_from_config`` and the ``VSR_*``
variables, runs the jobs and, on rank 0, saves each job's result (or its
traceback) for the test to hold against ``vsr_tpu``."""

from __future__ import annotations

import os
import pickle
import shutil
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
AUG = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
       {"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 2}}]
# task -> dataset, its tree and kwargs, trainer, net and its kwargs.
TASKS = {
    "drf": dict(dataset="AcdcVSRDataset", sub="videos",
                ds={"num_frames": 3, "temporal_order": "last"},
                trainer="AcdcVSRTrainer", net="DRFNet",
                net_kwargs=dict(in_channels=1, out_channels=1, num_features=8,
                                num_groups=2, upscale_factor=2,
                                fused_squeeze=True)),
    "duf": dict(dataset="AcdcMISRDataset", sub="videos", ds={"num_frames": 7},
                trainer="AcdcMISRTrainer", net="DUFNet",
                net_kwargs=dict(in_channels=1, out_channels=1, num_frames=7,
                                size_filter=3, upscale_factor=2)),
    "edsr": dict(dataset="AcdcSISRDataset", sub="imgs", ds={},
                 trainer="AcdcSISRTrainer", net="EDSRNet",
                 net_kwargs=dict(in_channels=1, out_channels=1,
                                 num_resblocks=1, num_features=8,
                                 upscale_factor=2)),
    "moe": dict(dataset="AcdcSISRDataset", sub="imgs", ds={},
                trainer="AcdcSISRTrainer", net="MoEEDSRNet",
                net_kwargs=dict(in_channels=1, out_channels=1,
                                num_resblocks=1, num_features=8,
                                upscale_factor=2, num_experts=4,
                                group_size=16, moe_every=1,
                                router_impl="rank_pallas")),
}
GLOBAL_BATCH, LR = 4, 1e-3


def _numpy(tree):
    return {k: v.detach().cpu().float().numpy() for k, v in tree.items()}


def _trainer(task, tree, weights, saved_dir, world, mode=None,
             opt=("Adam", {"lr": LR}), batch=GLOBAL_BATCH, mesh_axes=None,
             **knobs):
    from vsr_tpu_torch import losses, metrics, models, optim
    from vsr_tpu_torch.callbacks.monitor import Monitor
    from vsr_tpu_torch.data import datasets
    from vsr_tpu_torch.data.loader import Dataloader
    from vsr_tpu_torch.interop import load_jax_params
    from vsr_tpu_torch.runner import trainers

    t = TASKS[task]

    def dataset(type_):
        return getattr(datasets, t["dataset"])(
            data_dir=Path(tree) / t["sub"], type=type_, downscale_factor=2,
            transforms=NORM, augments=AUG, **t["ds"])

    net = getattr(models, t["net"])(**t["net_kwargs"])
    load_jax_params(net, weights)
    mesh = {"zero": dict(zero_optim=True), "fsdp": dict(fsdp=True)}.get(
        mode, {})
    mesh_axes = mesh_axes or {"data": world}
    return getattr(trainers, t["trainer"])(
        train_dataloader=Dataloader(dataset("train"),
                                    batch_size=batch // mesh_axes.get(
                                        "data", 1),
                                    shuffle=True, host_shard=True,
                                    drop_last=True),
        valid_dataloader=Dataloader(dataset("valid"), batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], optimizer=getattr(optim, opt[0])(**opt[1]),
        lr_scheduler=None, logger=None,
        monitor=Monitor(checkpoints_dir=Path(saved_dir) / "checkpoints",
                        mode="min", target="Loss", saved_freq=1,
                        early_stop=0),
        num_epochs=1, device="cpu", mesh_axes=mesh_axes, **mesh, **knobs)


def job_train(rank, world, task, tree, weights, out, epochs, mode=None,
              opt=("Adam", {"lr": LR}), valid=False, **knobs):
    """``epochs`` one-step epochs on a ``data`` mesh: the train losses,
    the validation log after them, the gathered state and EMA."""
    from vsr_tpu_torch.parallel.distributed import gather_sharded

    trainer = _trainer(task, tree, weights, out, world, mode, opt, **knobs)
    logs = [trainer._run_epoch("training", e)[0]["Loss"]
            for e in range(1, epochs + 1)]
    result = {"losses": logs,
              "valid": trainer._run_epoch("validation", epochs)[0]
              if valid else None,
              "state": _numpy(gather_sharded(trainer.net.state_dict())),
              "ema": (_numpy(gather_sharded(trainer.chain.ema_state()))
                      if knobs.get("ema_decay") else None),
              "mini_step": trainer.chain.mini_step}
    return result


def _diff(a: dict, b: dict) -> list:
    """The key paths where two full states (nests of tensors and values)
    differ."""
    from vsr_tpu_torch.utils.checkpoint import flatten_state

    fa, fb = flatten_state(a), flatten_state(b)
    out = sorted(map(str, set(fa) ^ set(fb)))
    for k in set(fa) & set(fb):
        v, w = fa[k], fb[k]
        if torch.is_tensor(v) or torch.is_tensor(w):
            same = (torch.is_tensor(v) and torch.is_tensor(w)
                    and torch.equal(v.cpu(), w.cpu()))
        else:
            same = v == w
        if not same:
            out.append(str(k))
    return out


def _raises(fn, exc, text) -> str:
    try:
        fn()
    except exc as err:
        return "ok" if text in str(err) else f"wrong message: {err}"
    return "did not raise"


def job_sharded(rank, world, task, tree, weights, out, mode):
    """``sharded_ckpt`` under ``mode``: save and restore at this world
    size (sync and async), the refusals, and the consolidation against the
    gathered state."""
    from vsr_tpu_torch.utils import checkpoint

    out = Path(out)
    trainer = _trainer(task, tree, weights, out / "a", world, mode,
                       sharded_ckpt=True)
    trainer._run_epoch("training", 1)
    path = out / f"{mode}.ckpt"
    trainer.save(path)
    full = trainer._dp.full_state(trainer)  # live tensors: copied
    full = full and checkpoint._map_tensors(torch.clone, full)
    restored = _trainer(task, tree, weights, out / "b", world, mode,
                        sharded_ckpt=True)
    restored.load(path)
    back = restored._dp.full_state(restored)  # a collective
    got = {"restored": _diff(back, full) if rank == 0 else None}
    again = _trainer(task, tree, weights, out / "c", world, mode,
                     sharded_ckpt=True, async_ckpt=True)
    again._run_epoch("training", 1)
    async_path = out / f"{mode}_async.ckpt"
    again.save(async_path)
    again.wait_for_checkpoints()
    dist.barrier()
    restored.load(async_path)
    back, want = restored._dp.full_state(restored), again._dp.full_state(again)
    got["async"] = _diff(back, want) if rank == 0 else None
    # A later save of another epoch, for the mixed-save check.
    trainer.epoch = 2
    trainer._run_epoch("training", 2)
    later = out / f"{mode}_later.ckpt"
    trainer.save(later)
    dist.barrier()
    if rank == 0:
        gathered = out / "gathered.ckpt"
        checkpoint.save_checkpoint(gathered, full, {})
        consolidated = out / "consolidated.ckpt"
        checkpoint.consolidate_sharded_checkpoint(path, consolidated)
        got["consolidated"] = _diff(
            checkpoint.load_checkpoint(consolidated)[0],
            checkpoint.load_checkpoint(gathered)[0])
        got["world1"] = _raises(
            lambda: checkpoint.load_checkpoint_sharded(path, 1), ValueError,
            f"written by {world} process(es) but this run has 1")
        mixed = out / "mixed"
        mixed.mkdir()
        for f in out.glob(f"{mode}.ckpt*"):
            shutil.copy(f, mixed / f.name)
        shutil.copy(out / f"{mode}_later.ckpt.shard1",
                    mixed / f"{mode}.ckpt.shard1")
        got["mixed"] = _raises(
            lambda: checkpoint.load_checkpoint_sharded(mixed / f"{mode}.ckpt",
                                                       world),
            ValueError, "is from a different save")
        (mixed / f"{mode}.ckpt.shard1").unlink()
        got["missing"] = _raises(
            lambda: checkpoint.load_checkpoint_sharded(mixed / f"{mode}.ckpt",
                                                       world),
            FileNotFoundError, "missing")
        got["plain_refused"] = _raises(
            lambda: checkpoint.load_checkpoint(path), ValueError,
            "is a sharded checkpoint")
        got["shards"] = sorted(p.name for p in out.glob(f"{mode}.ckpt*"))
    dist.barrier()
    return got


def job_preempt(rank, world, tree, weights, out):
    """A SIGTERM on rank 1 only, after the first of an epoch's 3 steps:
    the ranks agree to stop at the vote, write ``model_preempt.ckpt`` and
    a resumed run ends where the uninterrupted one does."""
    out = Path(out)
    straight = _trainer("edsr", tree, weights, out / "straight", world,
                        batch=2)
    straight.train()
    cut = _trainer("edsr", tree, weights, out / "cut", world, batch=2)
    step = cut._train_step

    def signal_after_the_first(inputs, targets):
        result = step(inputs, targets)
        cut._preempted = rank == 1
        return result

    cut._train_step = signal_after_the_first
    cut.train()
    resumed = _trainer("edsr", tree, weights, out / "resumed", world,
                       batch=2)
    resumed.load(out / "cut" / "checkpoints" / "model_preempt.ckpt")
    mid = resumed._mid_epoch_resume
    resumed.train()
    want, got = straight.net.state_dict(), resumed.net.state_dict()
    return {"mid_epoch": mid,
            "equal": all(torch.equal(got[k], want[k]) for k in want)}


def job_device(rank, world, tree, weights, out, steps, patch):
    """One device epoch of ``AcdcSISRDeviceTrainer`` on a ``data`` mesh:
    every rank's draws and block, and the gathered state."""
    from vsr_tpu_torch import losses, metrics, models, optim
    from vsr_tpu_torch.callbacks.monitor import Monitor
    from vsr_tpu_torch.data import datasets
    from vsr_tpu_torch.data.loader import Dataloader
    from vsr_tpu_torch.interop import load_jax_params
    from vsr_tpu_torch.registry import get_class

    def dataset(type_):
        return datasets.AcdcSISRDataset(
            data_dir=Path(tree) / "imgs", type=type_, downscale_factor=2,
            transforms=NORM, augments=AUG[:2])

    net = models.EDSRNet(**TASKS["edsr"]["net_kwargs"])
    load_jax_params(net, weights)
    trainer = get_class("trainer", "AcdcSISRDeviceTrainer")(
        train_dataloader=Dataloader(dataset("train"), batch_size=GLOBAL_BATCH,
                                    shuffle=True),
        valid_dataloader=Dataloader(dataset("valid"), batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], optimizer=optim.Adam(lr=LR),
        lr_scheduler=None, logger=None,
        monitor=Monitor(checkpoints_dir=Path(out) / "checkpoints",
                        mode="min", target="Loss", saved_freq=1,
                        early_stop=0),
        num_epochs=1, device="cpu", patch=patch, ratio=2,
        steps_per_epoch=steps, mesh_axes={"data": world})
    trainer._ensure_buffers()
    draws = [d.clone() for d in trainer.epoch_draws(1)]
    log, _, _ = trainer._run_epoch("training", 1)
    every = [None] * world
    dist.all_gather_object(every, {"draws": draws, "m": trainer.m,
                                   "batch": trainer._step_batch,
                                   "graph": trainer.engine.use_graph})
    return {"ranks": every, "log": log,
            "state": _numpy(trainer.net.state_dict())}


def job_main(rank, world, config):
    """``vsr_tpu_torch.main`` on a config with ``mesh_axes`` and
    ``host_shard``: the checkpoints and log it leaves (rank 0 writes)."""
    from vsr_tpu_torch import main as port_main

    port_main.main([str(config)])
    dist.barrier()
    saved = Path(config).parent / "run"
    return {"files": sorted(p.name for p in (saved / "checkpoints").glob("*"))}


JOBS = {"train": job_train, "sharded": job_sharded, "device": job_device,
        "main": job_main, "preempt": job_preempt}


def run_rank(rank: int, world: int, port: int, job_file: str) -> None:
    os.environ.update(VSR_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      VSR_NUM_PROCESSES=str(world), VSR_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    from vsr_tpu_torch.parallel import distributed

    distributed.initialize_from_config({"timeout": 120}, device="cpu")
    with open(job_file, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for name, kind, kwargs in jobs:
        try:
            if kind in JOBS:
                job = JOBS[kind]
            else:  # "module:function" of another test helper
                import importlib

                module, _, func = kind.partition(":")
                job = getattr(importlib.import_module(module), func)
            results[name] = job(rank, world, **kwargs)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        with open(job_file + ".out", "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn(jobs: list, workdir: Path, world: int = 2) -> dict:
    """Run ``jobs`` (``(name, kind, kwargs)``) on ``world`` gloo ranks in one
    spawn; returns rank 0's results by name."""
    import socket

    import torch.multiprocessing as mp

    job_file = str(Path(workdir) / "jobs.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(jobs, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(run_rank, args=(world, port, job_file), nprocs=world, join=True)
    with open(job_file + ".out", "rb") as f:
        return pickle.load(f)


def stack_draws(ranks: list[dict]) -> list[torch.Tensor]:
    """The world-1 draws of a ``data`` mesh's epoch: each rank's sample
    indices moved to its block of the whole split, the batches side by
    side in rank order."""
    out = []
    for i in range(len(ranks[0]["draws"])):
        parts = []
        for r, rank in enumerate(ranks):
            d = rank["draws"][i]
            parts.append(d + r * rank["m"] if i == 0 else d)
        out.append(torch.cat(parts, dim=1))
    return out

