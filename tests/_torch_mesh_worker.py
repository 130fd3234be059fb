"""The ranks' jobs of ``tests/test_torch_mesh_axes.py`` (the ``model`` and
``expert`` mesh axes, and ``data`` serving): run by
``tests/_torch_parallel_worker.spawn`` as ``"tests._torch_mesh_worker:<job>"``
kinds, in gloo ranks on the CPU that import torch and the port only."""

from __future__ import annotations

import threading
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tests._torch_parallel_worker import TASKS, _numpy, _trainer


def _net(name: str, kwargs: dict, weights: dict):
    from vsr_tpu_torch import models
    from vsr_tpu_torch.interop import load_jax_params

    net = getattr(models, name)(**kwargs)
    load_jax_params(net, weights)
    return net.eval()


def _gather_objects(obj) -> list:
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def serve(rank, world, cases):
    """Each case's pipeline over its mesh: ``(lr, sr)`` as numpy, and the
    shapes of the served net's parameters on every rank."""
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for case in cases:
        net = _net(case["net"], case["kwargs"], case["weights"])
        mesh = make_mesh(case["axes"])
        pipe = make_pipeline(net, 2, "acdc", mesh=mesh,
                             video_t=case.get("video_t", 0),
                             int8=case.get("int8", False),
                             w8a8=case.get("w8a8", False))
        lr, sr = pipe(torch.from_numpy(case["frames"]))
        shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
        out[case["name"]] = {"lr": lr.numpy(), "sr": sr.numpy(),
                             "shapes": _gather_objects(shapes)}
    return out


def _trainer_state(trainer) -> dict:
    """This rank's parameters and Adam moments, by parameter name."""
    names = [n for n, _ in trainer.net.named_parameters()]
    moments = {names[i]: {k: tuple(v.shape) for k, v in st.items()
                          if torch.is_tensor(v) and v.dim()}
               for i, st in trainer.optimizer.state_dict()["state"].items()}
    return {"params": _numpy(dict(trainer.net.named_parameters())),
            "moments": moments}


def train(rank, world, task, tree, weights, out, axes, epochs, opt,
          checkpoints=False, knobs=None):
    """``epochs`` one-step epochs of ``task`` on ``axes``: the losses, the
    gathered state, every rank's parameters and moment shapes, and with
    ``checkpoints`` a gathered and a sharded save restored at this
    topology, and the sharded one consolidated."""
    from vsr_tpu_torch.utils import checkpoint

    out = Path(out)
    knobs = knobs or {}
    trainer = _trainer(task, tree, weights, out / "a", world,
                       opt=opt, mesh_axes=axes, **knobs)
    losses = [trainer._run_epoch("training", e)[0]["Loss"]
              for e in range(1, epochs + 1)]
    full = checkpoint._map_tensors(torch.clone, trainer._dp.full_state(
        trainer))
    result = {"losses": losses, "state": _numpy(full["net"]),
              "ranks": _gather_objects(_trainer_state(trainer)),
              "groups": {a: (trainer.mesh.coord(a), trainer.mesh.size(a))
                         for a in trainer.mesh.axis_names}}
    result["ranks_groups"] = _gather_objects(result["groups"])
    if not checkpoints:
        return result
    gathered = out / "gathered.ckpt"
    trainer.save(gathered)
    dist.barrier()
    again = _trainer(task, tree, weights, out / "b", world,
                     opt=opt, mesh_axes=axes, **knobs)
    again.load(gathered)
    back = again._dp.full_state(again)
    from tests._torch_parallel_worker import _diff

    result["gathered_restored"] = _diff(back, full) if rank == 0 else None
    sharded = _trainer(task, tree, weights, out / "c", world,
                       opt=opt, mesh_axes=axes,
                       sharded_ckpt=True, **knobs)
    sharded.load(gathered)
    path = out / "sharded.ckpt"
    sharded.save(path)
    dist.barrier()
    restored = _trainer(task, tree, weights, out / "d", world,
                        opt=opt, mesh_axes=axes,
                        sharded_ckpt=True, **knobs)
    restored.load(path)
    back = restored._dp.full_state(restored)
    result["sharded_restored"] = _diff(back, full) if rank == 0 else None
    if rank == 0:
        whole = out / "consolidated.ckpt"
        checkpoint.consolidate_sharded_checkpoint(path, whole)
        result["consolidated"] = _diff(checkpoint.load_checkpoint(whole)[0],
                                       full)
        result["shards"] = sorted(p.name for p in out.glob("sharded.ckpt*"))
        result["gathered"] = str(gathered)
    dist.barrier()
    return result


def infer_cli(rank, world, argv):
    """``vsr_tpu_torch.infer.main`` on every rank."""
    from vsr_tpu_torch import infer

    stats = infer.main(argv)
    dist.barrier()
    return {"frames": stats["frames"]}


def daemon(rank, world, argv, frames, requests):
    """``vsr_tpu_torch.serve.main`` on every rank: rank 0's client posts
    ``requests`` volumes and then stops the server (SIGTERM), which stops
    the follower ranks. Returns the responses and the follower's calls."""
    import io
    import os
    import signal

    from vsr_tpu_torch import serve

    got = {"responses": [], "followed": None}
    if rank == 0:
        servers = []
        make_server = serve.make_server

        def recording(*args, **kwargs):
            servers.append(make_server(*args, **kwargs))
            return servers[-1]

        def client():
            while not servers:
                threading.Event().wait(0.05)
            port = servers[0].server_address[1]
            for _ in range(requests):
                buf = io.BytesIO()
                np.save(buf, frames)
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/sr", data=buf.getvalue(),
                    headers={"Content-Type": "application/x-npy"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    got["responses"].append(np.load(io.BytesIO(resp.read())))
            os.kill(os.getpid(), signal.SIGTERM)

        serve.make_server = recording
        thread = threading.Thread(target=client)
        thread.start()
        try:
            serve.main(argv)
        finally:
            serve.make_server = make_server
        thread.join()
    else:
        follow = serve.follow

        def counted(live, device):
            got["followed"] = follow(live, device)
            return got["followed"]

        serve.follow = counted
        try:
            serve.main(argv)
        finally:
            serve.follow = follow
    got["followed"] = _gather_objects(got["followed"])[1]
    return got
