"""Data-parallel training of the port (``vsr_tpu_torch/parallel``) against
``vsr_tpu``'s ``data`` mesh.

The JAX trainer runs ``mesh_axes: {data: 2}`` on 2 of the 8 host devices
of ``tests/conftest.py`` (global batch 4, one batch an epoch); the port
runs the same global batch on 2 gloo ranks, each reading its block with
``host_shard``. All the multi-process cases run in one
``torch.multiprocessing.spawn`` (``tests/_torch_parallel_worker.py``):
- a K1 net (DRFNet with ``fused_squeeze``) and a BatchNorm net (DUFNet),
  three Adam steps each, against JAX: each step's loss to 1e-5 relative,
  the parameters to 1e-5 of each leaf's largest entry, the running
  statistics to 1e-6; ``zero_optim`` and ``fsdp`` against the port's
  plain ``data`` run at the same tolerance;
- ``grad_accumulation: 2`` with ``grad_clip`` and ``ema_decay`` (DDP's
  ``no_sync`` micro-steps, ZeRO-1, FSDP's sharded clip) against JAX;
- ``sharded_ckpt`` under ZeRO-1 and FSDP: save and restore at world size 2
  (sync and async), the refusals, the consolidation against the gathered
  save;
- the device trainer's ``data: 2`` against the port's world-1 run fed the
  same draws;
- a SIGTERM on one rank: the ranks agree to stop, and the resumed run ends
  with the uninterrupted run's parameters;
- ``vsr_tpu_torch.main`` with ``mesh_axes`` and ``host_shard`` (the ranks
  join through ``main.distributed``'s ``VSR_*`` variables).
The single-process cases: ``host_shard`` against JAX's ``Dataloader``, and
``main.distributed``'s overrides and refusals.
"""

import functools
import socket

import jax
import numpy as np
import pytest
import torch

from tests._torch_cases import run_cases, subdir
from tests._torch_parallel_worker import (AUG, GLOBAL_BATCH, LR, NORM, TASKS,
                                          spawn, stack_draws)
from tests._torch_parity import init, randomize
from tests.synth import make_processed_tree
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import models as jmodels
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.runner import trainers as jtrainers
from vsr_tpu.utils.rng import RngTree as JaxRngTree
from vsr_tpu_torch import losses, metrics, models, optim
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.config import load_config, save_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data import loader as port_loader
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.parallel import distributed
from vsr_tpu_torch.parallel.mesh import make_mesh
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.utils.rng import RngTree

EPOCHS = 3
KNOBS = dict(grad_accumulation=2, grad_clip=0.05, ema_decay=0.9)
# Adam's eps for the BatchNorm net: with 1e-8 the noise gradient of a bias
# before a BatchNorm becomes a +-lr step (ROADMAP.md, care for new tests).
ADAM = ("Adam", {"lr": LR, "eps": 1e-5})
BN_OPT = ("SGD", {"lr": 0.02, "momentum": 0.9})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # One 7-frame sequence of 32 x 32 a split: 7 SISR images, VSR and MISR
    # windows; a global batch of 4 gives one train batch an epoch.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=32,
                               frames=7, patients_per_type=1, slices=1)


def _jax_dataset(task, tree, type_):
    t = TASKS[task]
    return getattr(jdatasets, t["dataset"])(
        data_dir=tree / t["sub"], type=type_, downscale_factor=2,
        transforms=NORM, augments=AUG, **t["ds"])


def _jax_run(task, tree, ckpt_dir, epochs=EPOCHS, opt=("Adam", {"lr": LR}),
             valid=False, mesh_axes=None, **knobs):
    """The JAX trainer on ``mesh_axes`` (default ``{data: 2}``): the
    initial variables, each step's loss, the validation log, the final
    variables and EMA."""
    t = TASKS[task]
    jt = getattr(jtrainers, t["trainer"])(
        train_dataloader=JaxDataloader(_jax_dataset(task, tree, "train"),
                                       batch_size=GLOBAL_BATCH, shuffle=True,
                                       drop_last=True),
        valid_dataloader=JaxDataloader(_jax_dataset(task, tree, "valid"),
                                       batch_size=1),
        net=getattr(jmodels, t["net"])(**t["net_kwargs"]),
        loss_fns=[jlosses.L1Loss()], loss_weights=[1.0],
        metric_fns=[jmetrics.PSNR()],
        optimizer=getattr(joptim, opt[0])(**opt[1]),
        lr_scheduler=None, logger=None,
        monitor=JaxMonitor(checkpoints_dir=ckpt_dir, mode="min",
                           target="Loss", saved_freq=1, early_stop=0),
        num_epochs=epochs, prefetch_to_device=False,
        mesh_axes=mesh_axes or {"data": 2}, **knobs)
    kw = {"train": False} if jt._net_train_kwarg else {}
    jt.params = randomize(init(jt.net, np.zeros(jt._example_inputs().shape,
                                                np.float32), **kw),
                          np.random.default_rng(0))
    jt.opt_state = jt.tx.init(jt.params["params"])
    jt._place_state()
    initial = jax.tree_util.tree_map(np.array, jt.params)
    step_losses = [jt._run_epoch("training", e)[0]["Loss"]
                   for e in range(1, epochs + 1)]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(
        initial=initial, losses=step_losses,
        valid=jt._run_epoch("validation", epochs)[0] if valid else None,
        final=to_np(jt.params),
        ema=(to_np(joptim.get_ema_params(jt.opt_state))
             if knobs.get("ema_decay") else None))


def _port_net(task):
    return getattr(models, TASKS[task]["net"])(**TASKS[task]["net_kwargs"])


def _hold_state(got: dict, want: dict, what: str) -> None:
    """Parameters to 1e-5 of each leaf's largest entry, or of the learning
    rate where a leaf is smaller than one step (a PReLU slope of 3.5e-4
    ends 7.5e-9 apart between the port and JAX in one process already);
    running statistics to 1e-6."""
    assert sorted(got) == sorted(want), what
    for name, value in want.items():
        atol = (1e-6 if "running_" in name
                else 1e-5 * max(float(np.abs(value).max()), LR))
        np.testing.assert_allclose(got[name], value, rtol=0, atol=atol,
                                   err_msg=f"{what}: {name}")


def _check(result):
    assert "error" not in result, result.get("error")
    return result


def _case_against_jax(results, want, task, modes, what):
    net = _port_net(task)
    flax = from_jax_tree(net, want["final"])
    plain = _check(results[f"{what} ddp"])
    np.testing.assert_allclose(plain["losses"], want["losses"], rtol=1e-5)
    _hold_state(plain["state"], {k: flax[k] for k in plain["state"]},
                f"{what} ddp")
    if want["ema"] is not None:
        _hold_state(plain["ema"], from_jax_tree(net, {"params": want["ema"]}),
                    f"{what} ddp ema")
    moved = from_jax_tree(net, want["initial"])
    assert sum(np.abs(flax[k] - moved[k]).max() > 1e-4 for k in flax) > 3
    for mode in modes:
        got = _check(results[f"{what} {mode}"])
        np.testing.assert_allclose(got["losses"], plain["losses"], rtol=1e-5)
        _hold_state(got["state"], plain["state"], f"{what} {mode}")
        if plain["ema"] is not None:
            _hold_state(got["ema"], plain["ema"], f"{what} {mode} ema")
        assert got["mini_step"] == plain["mini_step"]
    return plain


def _case_valid_split(results, want):
    got = _check(results["drf ddp"])["valid"]
    assert sorted(got) == sorted(want["valid"])
    for key, value in want["valid"].items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


def _case_sharded(results, mode):
    got = _check(results[f"sharded {mode}"])
    assert got["shards"] == [f"{mode}.ckpt", f"{mode}.ckpt.shard0",
                             f"{mode}.ckpt.shard1"]
    for key in ("restored", "async", "consolidated"):
        assert got[key] == [], key
    for key in ("world1", "mixed", "missing", "plain_refused"):
        assert got[key] == "ok", (key, got[key])


def _case_device(results, tree, weights, tmp_path):
    got = _check(results["device"])
    ranks = got["ranks"]
    assert [r["batch"] for r in ranks] == [GLOBAL_BATCH // 2] * 2
    assert ranks[0]["m"] == ranks[1]["m"] == 3  # 7 samples -> 6, 3 a rank
    assert not ranks[0]["graph"]  # gloo: eager steps
    net = _port_net("edsr")
    load_jax_params(net, weights)
    ds = [datasets.AcdcSISRDataset(data_dir=tree / "imgs", type=t,
                                   downscale_factor=2, transforms=NORM,
                                   augments=AUG[:2]) for t in
          ("train", "valid")]
    pt = get_class("trainer", "AcdcSISRDeviceTrainer")(
        train_dataloader=port_loader.Dataloader(ds[0],
                                                batch_size=GLOBAL_BATCH),
        valid_dataloader=port_loader.Dataloader(ds[1], batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], optimizer=optim.Adam(lr=LR),
        lr_scheduler=None, logger=None,
        monitor=Monitor(checkpoints_dir=tmp_path, mode="min", target="Loss",
                        saved_freq=1, early_stop=0),
        num_epochs=1, device="cpu", patch=4, ratio=2, steps_per_epoch=2,
        buffer_limit=6)
    pt._ensure_buffers()
    draws = stack_draws(ranks)
    pt.epoch_draws = lambda epoch: draws
    log, _, _ = pt._run_epoch("training", 1)
    np.testing.assert_allclose(got["log"]["Loss"], log["Loss"], rtol=1e-5)
    _hold_state(got["state"], {k: v.numpy() for k, v in
                               pt.net.state_dict().items()}, "device")


def _main_config(tree, run_dir):
    cfg = load_config("configs/train/acdc_sisr_edsr_x2.yaml")
    cfg.main.saved_dir = str(run_dir)
    cfg.dataset.kwargs.data_dir = str(tree / "imgs")
    cfg.dataset.kwargs.augments = AUG
    cfg.dataloader.kwargs.update(train_batch_size=GLOBAL_BATCH // 2,
                                 host_shard=True)
    cfg.net.kwargs = TASKS["edsr"]["net_kwargs"]
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs = {"num_epochs": 1, "device": "cpu",
                          "mesh_axes": {"data": 2}, "zero_optim": True}
    return cfg


def _case_preempt(results):
    got = _check(results["preempt"])
    assert got["mid_epoch"]["steps_done"] == 1, got
    assert got["mid_epoch"]["batches_total"] == 3, got
    assert got["equal"] is True


def _case_main(results):
    assert _check(results["main"])["files"] == ["model_1.ckpt",
                                                "model_best.ckpt"]


def test_data_parallel_ranks_match_the_jax_mesh(tree, tmp_path):
    jax_dir = subdir(tmp_path, "jax")
    want = {
        "drf": _jax_run("drf", tree, jax_dir, opt=ADAM, valid=True),
        "duf": _jax_run("duf", tree, jax_dir, opt=BN_OPT),
        "knobs": _jax_run("edsr", tree, jax_dir, epochs=4, opt=ADAM,
                          **KNOBS),
    }
    edsr_weights = init(jmodels.EDSRNet(**TASKS["edsr"]["net_kwargs"]),
                        np.zeros((1, 8, 8, 1), np.float32))
    jobs = []
    for what, task, extra in (("drf", "drf", dict(opt=ADAM, valid=True)),
                              ("duf", "duf", dict(opt=BN_OPT)),
                              ("knobs", "edsr", dict(epochs=4, opt=ADAM,
                                                     **KNOBS))):
        for mode in ("ddp", "zero", "fsdp"):
            jobs.append((f"{what} {mode}", "train", dict(
                dict(task=task, tree=tree, weights=want[what]["initial"],
                     out=str(subdir(tmp_path, f"{what}_{mode}")),
                     epochs=EPOCHS, mode=None if mode == "ddp" else mode),
                **extra)))
    for mode in ("zero", "fsdp"):
        jobs.append((f"sharded {mode}", "sharded", dict(
            task="drf", tree=tree, weights=want["drf"]["initial"],
            out=str(subdir(tmp_path, f"sharded_{mode}")), mode=mode)))
    jobs.append(("device", "device", dict(
        tree=tree, weights=edsr_weights, out=str(subdir(tmp_path, "device")),
        steps=2, patch=4)))
    jobs.append(("preempt", "preempt", dict(
        tree=tree, weights=edsr_weights, out=str(subdir(tmp_path, "preempt"))
    )))
    main_dir = subdir(tmp_path, "main")
    save_config(_main_config(tree, main_dir / "run"), main_dir / "cfg.yaml")
    jobs.append(("main", "main", dict(config=str(main_dir / "cfg.yaml"))))
    results = spawn(jobs, subdir(tmp_path, "spawn"))
    run_cases([
        ("K1 net: ddp, zero, fsdp against JAX", lambda: _case_against_jax(
            results, want["drf"], "drf", ("zero", "fsdp"), "drf")),
        ("validation split", lambda: _case_valid_split(results, want["drf"])),
        ("BatchNorm net: ddp, zero, fsdp against JAX",
         lambda: _case_against_jax(results, want["duf"], "duf",
                                   ("zero", "fsdp"), "duf")),
        ("accumulation, clip, EMA against JAX", lambda: _case_against_jax(
            results, want["knobs"], "edsr", ("zero", "fsdp"), "knobs")),
        ("sharded_ckpt, ZeRO-1", lambda: _case_sharded(results, "zero")),
        ("sharded_ckpt, FSDP", lambda: _case_sharded(results, "fsdp")),
        ("device trainer", lambda: _case_device(
            results, tree, edsr_weights, subdir(tmp_path, "device1"))),
        ("preemption on one rank", lambda: _case_preempt(results)),
        ("main", lambda: _case_main(results)),
    ])


# ------------------------------------------------------- one process


def _case_host_shard_blocks(tree, monkeypatch):
    for task in ("drf", "edsr"):
        jds = _jax_dataset(task, tree, "train")
        t = TASKS[task]
        pds = getattr(datasets, t["dataset"])(
            data_dir=tree / t["sub"], type="train", downscale_factor=2,
            transforms=NORM, augments=AUG, **t["ds"])
        for rank in (0, 1):
            monkeypatch.setattr(port_loader, "process_count", lambda: 2)
            monkeypatch.setattr(port_loader, "process_index", lambda: rank)
            jl = JaxDataloader(jds, batch_size=2, shuffle=True,
                               host_shard=True)
            jl._host_shard_override = (2, rank)
            pl = port_loader.Dataloader(pds, batch_size=2, shuffle=True,
                                        host_shard=True)
            assert len(pl) == len(jl) == 1  # 7 // 4: the tail dropped
            jb = list(jl.epoch(JaxRngTree("vsr"), 1))
            pb = list(pl.epoch(RngTree("vsr"), 1))
            for a, b in zip(jb, pb):
                assert sorted(a) == sorted(b)
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    monkeypatch.setattr(port_loader, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="one global batch needs"):
        list(port_loader.Dataloader(pds, batch_size=2,
                                    host_shard=True).epoch(None, 0))
    assert distributed.host_shard_len(7, 2) == 3  # one process
    assert distributed.process_shard(7) == slice(0, 7)
    mesh = make_mesh({"data": -1})
    assert mesh.shape == {"data": 1}
    assert distributed.mesh_process_blocks(mesh) == {"data": (0, 1)}
    for axes, error, match in (
            ({"data": -1, "seq": -1}, ValueError, "Only one mesh axis"),
            ({"data": -1, "seq": 2}, ValueError, "1 devices not divisible"),
            ({"data": 1, "pipe": 1}, NotImplementedError, "'pipe'"),
            ({"data": 1, "spatial": 1}, NotImplementedError, "'spatial'"),
            ({"data": 2}, ValueError, "Mesh needs 2 devices, have 1")):
        with pytest.raises(error, match=match):
            make_mesh(axes)


def _case_distributed_config(monkeypatch):
    calls = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda **kw: calls.append(kw))
    for key in ("VSR_COORDINATOR_ADDRESS", "VSR_NUM_PROCESSES",
                "VSR_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    distributed.initialize_from_config(None, device="cpu")
    assert calls == []  # no section, no VSR_NUM_PROCESSES: one process
    distributed.initialize_from_config(
        {"coordinator_address": "h:1", "num_processes": 4, "process_id": 2})
    monkeypatch.setenv("VSR_PROCESS_ID", "3")
    monkeypatch.setenv("VSR_NUM_PROCESSES", "4")
    distributed.initialize_from_config(
        {"coordinator_address": "h:1", "num_processes": 8, "process_id": 0,
         "timeout": 5}, device="cpu")
    distributed.initialize_from_config("auto")
    assert calls[0] == dict(coordinator_address="h:1", num_processes=4,
                            process_id=2, device="cuda", timeout_s=600.0)
    assert calls[1] == dict(coordinator_address="h:1", num_processes=4,
                            process_id=3, device="cpu", timeout_s=5.0)
    assert calls[2]["num_processes"] == 4 and calls[2]["process_id"] == 3
    assert distributed.choose_backend("cuda", 1, 1) == "nccl"
    assert distributed.choose_backend("cuda", 2, 1) == "gloo"
    assert distributed.choose_backend("cpu", 2, 0) == "gloo"


def _case_explicit_identity_that_fails_raises(monkeypatch):
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with socket.socket() as taken:  # rank 0's port is in use
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        with pytest.raises(RuntimeError, match="explicit coordinator"):
            distributed.initialize(f"127.0.0.1:{port}", 2, 0, device="cpu",
                                   timeout_s=5)
    with pytest.raises(RuntimeError, match="needs a coordinator address"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="does not move to the CPU"):
            distributed.initialize("127.0.0.1:1", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()


def test_host_shard_and_main_distributed(tree, monkeypatch):
    def patched(case, *args):
        def thunk():
            with monkeypatch.context() as m:
                case(*args, m)
        return thunk

    run_cases([
        ("host_shard against JAX's loader",
         patched(_case_host_shard_blocks, tree)),
        ("main.distributed and the VSR_* overrides",
         patched(_case_distributed_config)),
        ("an explicit identity that fails raises",
         patched(_case_explicit_identity_that_fails_raises)),
    ])
