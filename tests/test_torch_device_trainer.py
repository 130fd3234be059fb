"""The device-epoch trainers (``vsr_tpu_torch/runner/device_trainer.py``)
against ``vsr_tpu/runner/device_trainer.py`` on one tiny tree.

- ``stack_dataset_raw`` and ``apply_draws`` bit-equal to JAX's (buffers in
  the port's channel-first layout; the draws are the ones JAX derives from
  its keys).
- One short device epoch per family of the config-driven trainers (SISR,
  VSR, 3D, 4D) and of the standalone ``DeviceEpochTrainer`` over VSR
  windows, fed JAX's draws, against the
  JAX epoch from the same weights: per-step losses within 1e-4 relative,
  parameters after the epoch within 3e-4 of their largest entry.
- The 14 names, every refusal, host <-> device checkpoints, and
  ``vsr_tpu_torch.main`` on a tiny ``*_device``-shaped config (2 epochs,
  then a resume). On the CPU the step runs eagerly; the captured CUDA graph
  is held against the eager step by ``tests/test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import init, randomize
from tests.synth import make_processed_tree
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import models as jmodels
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.runner import device_trainer as jdt
from vsr_tpu.utils.normalize import DATASET_STATS
from vsr_tpu_torch import losses, metrics, models, optim
from vsr_tpu_torch import main as port_main
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.config import load_config, save_config
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.runner import device_trainer as dt
from vsr_tpu_torch.runner import trainers

NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
AUG = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"}]
BATCH, PATCH, STEPS = 2, 4, 3
FAMILIES = {
    "sisr": dict(dataset="AcdcSISRDataset", sub="imgs", ds={},
                 trainer="AcdcSISRDeviceTrainer", net="EDSRNet", time=False,
                 net_kwargs=dict(in_channels=1, out_channels=1,
                                 num_resblocks=1, num_features=4,
                                 upscale_factor=2, fused_tail=True)),
    "vsr": dict(dataset="AcdcVSRDataset", sub="videos", ds={"num_frames": 3},
                trainer="AcdcVSRDeviceTrainer", net="DRFNet", time=True,
                net_kwargs=dict(in_channels=1, out_channels=1, num_features=4,
                                num_groups=1, upscale_factor=2,
                                fused_tail=True)),
    "3d": dict(dataset="AcdcVolumeDataset", sub="videos", ds={},
               trainer="Acdc3DSRDeviceTrainer", net="Volume3DSRNet",
               time=False,
               net_kwargs=dict(in_channels=1, out_channels=1, num_resblocks=1,
                               num_features=4, upscale_factor=2,
                               fused_tail=True)),
    "4d": dict(dataset="AcdcVolumeVSRDataset", sub="videos",
               ds={"num_frames": 3}, trainer="Acdc4DSRDeviceTrainer",
               net="Volume4DSRNet", time=True,
               net_kwargs=dict(in_channels=1, out_channels=1, num_features=4,
                               num_resblocks=1, upscale_factor=2,
                               remat=True, fused_tail=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 1 patient x 3 slices x 4 frames of 16 x 16 per split.
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=16,
                               frames=4, patients_per_type=1, slices=3)


def _dataset(module, family, tree, type_="train"):
    f = FAMILIES[family]
    return getattr(module, f["dataset"])(
        data_dir=tree / f["sub"], type=type_, downscale_factor=2,
        transforms=NORM, augments=AUG, **f["ds"])


def _to_port(a: np.ndarray, time: bool) -> torch.Tensor:
    """JAX net layout (M, [T,] [D,] h, w, C) -> the port's (M, [T,] C, ...)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 2 if time else 1)))


def _jax_draws(key, m, batch, h, w, patch, window=False, t_full=None):
    """The draws the JAX samplers derive from one step key: the mixin's
    ``_sample_batch`` (and with ``window`` the standalone trainer's) and
    ``sample_crop_flip``."""
    if window:
        k_idx, k_t, k_aug = jax.random.split(key, 3)
    else:
        k_idx, k_aug = jax.random.split(key)
    idx = jax.random.randint(k_idx, (batch,), 0, m)
    k_y, k_x, k_hf, k_vf = jax.random.split(k_aug, 4)
    out = [idx, jax.random.randint(k_y, (batch,), 0, h - patch + 1),
           jax.random.randint(k_x, (batch,), 0, w - patch + 1),
           jax.random.bernoulli(k_hf, 0.5, (batch,)),
           jax.random.bernoulli(k_vf, 0.5, (batch,))]
    if window:
        out.append(jax.random.randint(k_t, (batch,), 0, t_full))
    return [torch.from_numpy(np.asarray(d)) for d in out]


def _epoch_draws(epoch_key, steps, **kw):
    per_step = [_jax_draws(k, **kw) for k in jax.random.split(epoch_key, steps)]
    return [torch.stack(parts) for parts in zip(*per_step)]


# --------------------------------------------------------- buffers, draws


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stack_dataset_raw_is_bit_equal_to_jax(tree, family):
    port_ds, jax_ds = (_dataset(datasets, family, tree),
                       _dataset(jdatasets, family, tree))
    got = dt.stack_dataset_raw(port_ds, limit=5)
    want = jdt.stack_dataset_raw(jax_ds, limit=5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].max() > 1.5  # raw [0, 255] values, not normalized
    assert port_ds.transforms is not None  # restored


@pytest.mark.parametrize("layout", ["frames", "windows", "volumes", "4d"])
def test_apply_draws_is_bit_equal_to_jax(rng, layout):
    lead = {"frames": (), "windows": (3,), "volumes": (2,),
            "4d": (3, 2)}[layout]
    lr = np.round(rng.random((5, *lead, 6, 7, 1)) * 255).astype(np.float32)
    hr = np.round(rng.random((5, *lead, 12, 14, 1)) * 255).astype(np.float32)
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(key, m=5, batch=4, h=6, w=7, patch=4)
    k_idx, k_aug = jax.random.split(key)
    idx = jax.random.randint(k_idx, (4,), 0, 5)
    stats = DATASET_STATS["acdc"]
    want = jax.jit(lambda k, a, b: jdt.sample_crop_flip(
        k, a, b, 4, 2, stats))(k_aug, jnp.asarray(lr)[idx],
                               jnp.asarray(hr)[idx])
    time = layout in ("windows", "4d")
    got = dt.apply_draws(_to_port(lr, time), _to_port(hr, time), draws, 4, 2,
                         stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _to_port(w, time).numpy())


def test_circular_windows_wrap_like_jax(rng):
    seq = rng.standard_normal((3, 5, 1, 2, 2)).astype(np.float32)
    t0 = torch.tensor([0, 3, 4])
    got = dt.take_windows(torch.from_numpy(seq), t0, 3).numpy()
    for b, start in enumerate([0, 3, 4]):
        np.testing.assert_array_equal(
            got[b], seq[b, [(start + i) % 5 for i in range(3)]])


def test_draw_batch_shapes_ranges_and_seed():
    gen = torch.Generator().manual_seed(1)
    idx, y0, x0, hf, vf = dt.draw_batch(gen, 7, (50, 4), 6, 9, 4)
    assert idx.shape == y0.shape == hf.shape == (50, 4)
    assert 0 <= int(idx.min()) and int(idx.max()) < 7
    assert int(y0.max()) <= 2 and int(x0.max()) <= 5
    assert hf.dtype == torch.bool and 0 < float(hf.float().mean()) < 1
    again = dt.draw_batch(torch.Generator().manual_seed(1), 7, (50, 4), 6, 9,
                          4)
    assert all(torch.equal(a, b) for a, b in zip((idx, y0, x0, hf, vf),
                                                 again))
    with pytest.raises(ValueError, match="patch 7"):
        dt.draw_batch(gen, 7, 4, 6, 9, 7)


# -------------------------------------------------- epochs against JAX


def _jax_trainer(family, tree, tmp_path):
    f = FAMILIES[family]
    jt = getattr(jdt, f["trainer"])(
        train_dataloader=JaxDataloader(_dataset(jdatasets, family, tree),
                                       batch_size=BATCH, shuffle=True),
        valid_dataloader=JaxDataloader(
            _dataset(jdatasets, family, tree, "valid"), batch_size=1),
        net=getattr(jmodels, f["net"])(**f["net_kwargs"]),
        loss_fns=[jlosses.L1Loss()], loss_weights=[1.0],
        metric_fns=[jmetrics.PSNR()], optimizer=joptim.Adam(lr=1e-3),
        lr_scheduler=None, logger=None,
        monitor=JaxMonitor(checkpoints_dir=tmp_path, mode="min",
                           target="Loss", saved_freq=1, early_stop=0),
        num_epochs=1, patch=PATCH, ratio=2, steps_per_epoch=STEPS,
        prefetch_to_device=False)
    example = jt._example_inputs()
    # Non-zero biases: with zero biases and PReLU weights (``init``), a
    # pixel whose F=4 inputs are all negative gives a pre-activation of
    # exactly 0, the PReLU's kink, where the port's gradient (alpha) and
    # JAX's max / min form (the tie split, (1 + alpha) / 2) differ.
    jt.params = randomize(init(jt.net, np.zeros(example.shape, np.float32)),
                          np.random.default_rng(0))
    jt.opt_state = jt.tx.init(jt.params["params"])
    return jt


def _port_trainer(family, tree, tmp_path, weights=None, **kw):
    f = FAMILIES[family]
    net = getattr(models, f["net"])(**f["net_kwargs"])
    if weights is not None:
        load_jax_params(net, weights)
    return get_class("trainer", f["trainer"])(
        train_dataloader=Dataloader(_dataset(datasets, family, tree),
                                    batch_size=BATCH, shuffle=True),
        valid_dataloader=Dataloader(_dataset(datasets, family, tree, "valid"),
                                    batch_size=1),
        net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
        metric_fns=[metrics.PSNR()], optimizer=optim.Adam(lr=1e-3),
        lr_scheduler=None, logger=None,
        monitor=Monitor(checkpoints_dir=tmp_path, mode="min", target="Loss",
                        saved_freq=1, early_stop=0),
        num_epochs=1, patch=PATCH, ratio=2, steps_per_epoch=STEPS,
        device="cpu", **kw)


def _jax_step_losses(jt, keys):
    """JAX's per-step losses: the epoch's scan body, step by step."""
    @jax.jit
    def body(params, opt_state, key):
        inputs, hr = jt._sample_batch(key)
        params, opt_state, scalars, _ = jt._step(
            params, opt_state, inputs, jt._pack_device_targets(hr, inputs),
            training=True)
        return params, opt_state, scalars["Loss"]

    params, opt_state, out = jt.params, jt.opt_state, []
    for key in keys:
        params, opt_state, loss = body(params, opt_state, key)
        out.append(float(loss))
    return out


def _hold_params(net, want_tree):
    want = from_jax_tree(net, jax.tree_util.tree_map(np.asarray, want_tree))
    state = net.state_dict()
    assert sorted(want) == sorted(state)
    for name, value in state.items():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(value.numpy(), want[name], rtol=0,
                                   atol=3e-4 * scale, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_device_epoch_matches_jax(tree, tmp_path, family):
    jt = _jax_trainer(family, tree, tmp_path / "jax")
    initial = jax.tree_util.tree_map(np.array, jt.params)
    h, w = jt.lr_buf.shape[-3], jt.lr_buf.shape[-2]
    key = jt.rng_tree.jax_key("device-epoch", 1)
    step_losses = _jax_step_losses(jt, jax.random.split(key, STEPS))
    jlog, _, _ = jt._run_epoch("training", 1)

    pt = _port_trainer(family, tree, tmp_path / "port", initial)
    draws = _epoch_draws(key, STEPS, m=jt.m, batch=BATCH, h=h, w=w,
                         patch=PATCH)
    pt.epoch_draws = lambda epoch: draws
    log, batch, outputs = pt._run_epoch("training", 1)
    assert batch is None and outputs is None
    np.testing.assert_array_equal(
        pt.lr_buf.numpy(), _to_port(jt.lr_buf, FAMILIES[family]["time"]))
    np.testing.assert_allclose(pt.engine.log[:, 0].numpy(), step_losses,
                               rtol=1e-4)
    assert sorted(log) == sorted(jlog) == ["L1Loss", "Loss", "PSNR"]
    for k, v in jlog.items():
        np.testing.assert_allclose(log[k], v, rtol=1e-4, err_msg=k)
    _hold_params(pt.net, jt.params)
    assert pt.engine.eager_steps == STEPS and pt.engine.replays == 0


def test_standalone_vsr_window_epoch_matches_jax(tree):
    """``DeviceEpochTrainer`` over whole sequences with circular 3-frame
    windows (DRFNet), fed the JAX trainer's draws."""
    ds = jdatasets.AcdcVSRDataset(data_dir=tree / "videos", type="valid",
                                  downscale_factor=2,
                                  transforms=[{"name": "ToTensor"}],
                                  num_frames=3)
    seqs = [ds.__getitem__(i) for i in range(len(ds))]
    lr = np.stack([s["lr_imgs"] for s in seqs])  # (S, T_full, h, w, C)
    hr = np.stack([s["hr_imgs"] for s in seqs])
    kw = dict(in_channels=1, out_channels=1, num_features=4, num_groups=1,
              upscale_factor=2)
    common = dict(loss_weights=[1.0], lr_data=None, hr_data=None,
                  batch_size=BATCH, patch=PATCH, ratio=2,
                  steps_per_epoch=STEPS, window=3)
    jt = jdt.DeviceEpochTrainer(
        net=jmodels.DRFNet(**kw), loss_fns=[jlosses.L1Loss()],
        metric_fns=[jmetrics.PSNR()], optimizer=joptim.Adam(lr=1e-3),
        **{**common, "lr_data": lr, "hr_data": hr})
    initial = jax.tree_util.tree_map(np.array, jt.params)

    @jax.jit
    def body(params, opt_state, key):
        inputs, targets = jt._sample_batch(key)
        params, opt_state, scalars = jt._train_step(params, opt_state, inputs,
                                                    targets)
        return params, opt_state, scalars["Loss"]

    key = jt.rng_tree.jax_key("device-epoch", 1)
    params, opt_state, step_losses = jt.params, jt.opt_state, []
    for k in jax.random.split(key, STEPS):
        params, opt_state, loss = body(params, opt_state, k)
        step_losses.append(float(loss))
    jlog = jt.train_epoch()

    net = models.DRFNet(**kw)
    load_jax_params(net, initial)
    pt = dt.DeviceEpochTrainer(
        net=net, loss_fns=[losses.L1Loss()], metric_fns=[metrics.PSNR()],
        optimizer=optim.Adam(lr=1e-3), device="cpu",
        **{**common, "lr_data": np.moveaxis(lr, -1, 2),
           "hr_data": np.moveaxis(hr, -1, 2)})
    draws = _epoch_draws(key, STEPS, m=len(lr), batch=BATCH, h=lr.shape[2],
                         w=lr.shape[3], patch=PATCH, window=True,
                         t_full=lr.shape[1])
    log = pt.train_epoch(draws)
    np.testing.assert_allclose(pt.engine.log[:, 0].numpy(), step_losses,
                               rtol=1e-4)
    assert sorted(log) == sorted(jlog) == ["Loss", "PSNR"]
    np.testing.assert_allclose(log["Loss"], jlog["Loss"], rtol=1e-4)
    _hold_params(pt.net, jt.params)
    # Its own draws: deterministic by seed.
    assert len(pt.draws(2)) == 6 and all(
        torch.equal(a, b) for a, b in zip(pt.draws(2), pt.draws(2)))


# ------------------------------------------------------- names, refusals


def test_the_fourteen_names_resolve():
    names = [f"{p}{f}DeviceTrainer" for f in ("SISR", "SISRSRFB", "MISR",
                                              "VSR", "FRVSR", "3DSR", "4DSR")
             for p in ("Acdc", "Dsb15")]
    for name in names:
        cls = get_class("trainer", name)
        assert issubclass(cls, dt.DeviceTrainerMixin)
        assert cls.dataset_stats == ("acdc" if name.startswith("Acdc")
                                     else "dsb15")
    assert issubclass(get_class("trainer", "AcdcFRVSRDeviceTrainer"),
                      trainers.FRVSRTrainer)
    assert issubclass(get_class("trainer", "Dsb154DSRDeviceTrainer"),
                      trainers.Volume4DTrainer)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh_axes={"data": 2}), "mesh_axes"),
    (dict(mesh_axes={"data": 1, "expert": 2}), "'expert'"),
    (dict(zero_optim=True), "zero_optim"), (dict(fsdp=True), "fsdp"),
    (dict(qat=True, mesh_axes={"pipe": 2}), "qat"),
    (dict(scan_unroll=2), "scan_unroll=2")])
def test_mixin_refusals(tree, tmp_path, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        _port_trainer("sisr", tree, tmp_path, **kwargs)


def test_mixin_refuses_a_multi_process_run(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="multi-process"):
        _port_trainer("sisr", tree, tmp_path)


@pytest.mark.parametrize("value", ["auto", 0, 1])
def test_scan_unroll_takes_auto_0_and_1(tree, tmp_path, value):
    trainer = _port_trainer("sisr", tree, tmp_path, scan_unroll=value)
    assert trainer.patch == PATCH


def test_standalone_refusals(rng):
    net = models.EDSRNet(**FAMILIES["sisr"]["net_kwargs"])
    buf = rng.random((4, 1, 8, 8)).astype(np.float32)
    kw = dict(net=net, loss_fns=[losses.L1Loss()], loss_weights=[1.0],
              metric_fns=[], optimizer=optim.Adam(), lr_data=buf,
              hr_data=np.repeat(np.repeat(buf, 2, -1), 2, -2), batch_size=2,
              patch=4, ratio=2, device="cpu")
    with pytest.raises(ValueError, match="unknown qat option"):
        dt.DeviceEpochTrainer(**kw, qat={"min_channel": 8})
    with pytest.raises(NotImplementedError, match="scan_unroll=4"):
        dt.DeviceEpochTrainer(**kw, scan_unroll=4)
    with pytest.raises(NotImplementedError, match="window=3"):
        dt.DeviceEpochTrainer(**kw, window=3)
    with pytest.raises(ValueError, match="float32 parameters"):
        dt.DeviceEpochTrainer(**{**kw, "net": net.to(torch.bfloat16)})
    with pytest.raises(NotImplementedError, match="capturable"):
        dt.make_capturable(torch.optim.LBFGS(net.parameters(), lr=0.1),
                           torch.device("cpu"))


def test_a_host_loop_mid_epoch_checkpoint_is_refused(tree, tmp_path):
    trainer = _port_trainer("sisr", tree, tmp_path)
    trainer._mid_epoch_resume = {"steps_done": 1}
    with pytest.raises(NotImplementedError, match="mid-epoch"):
        trainer._run_epoch("training", 1)


# ------------------------------------------------------------ checkpoints


def test_optimizer_state_converts_to_the_host_format():
    """A capturable optimizer's state (a tensor learning rate, ``capturable``
    on, step counts as tensors) becomes the host-loop format, which the
    host-loop Adam loads as it is."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=1e-3)
    p.grad = torch.ones(3)
    opt.step()
    state = opt.state_dict()
    state["param_groups"][0].update(lr=torch.tensor(1e-3), capturable=True)
    state["state"][0]["step"] = torch.tensor(5.0, dtype=torch.float64)
    host = dt.host_optimizer_state(state)
    assert host["param_groups"][0]["lr"] == pytest.approx(1e-3)
    assert host["param_groups"][0]["capturable"] is False
    step = host["state"][0]["step"]
    assert step.dtype == torch.float32 and step.device.type == "cpu"
    fresh = torch.nn.Parameter(torch.ones(3))
    again = torch.optim.Adam([fresh], lr=0.1)
    again.load_state_dict(host)
    fresh.grad = torch.ones(3)
    again.step()
    assert float(again.state[fresh]["step"]) == 6.0


def _config(tree, saved, trainer="AcdcSISRDeviceTrainer", num_epochs=2,
            loaded_path=None):
    cfg = load_config("configs/train/acdc_sisr_edsr_x2_device.yaml")
    cfg.main.saved_dir = str(saved)
    cfg.dataset.kwargs.data_dir = str(tree / "imgs")
    cfg.dataloader.kwargs.update(train_batch_size=BATCH, num_workers=0)
    cfg.net.kwargs.update(num_resblocks=1, num_features=4)
    cfg.metrics = [m for m in cfg.metrics if m["name"] == "PSNR"]
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.name = trainer
    cfg.trainer.kwargs.update(num_epochs=num_epochs, patch=PATCH,
                              steps_per_epoch=STEPS)
    if trainer == "AcdcSISRTrainer":
        for key in ("patch", "ratio", "steps_per_epoch"):
            cfg.trainer.kwargs.pop(key)
        cfg.dataset.kwargs.augments = [
            *AUG, {"name": "RandomCropPatch",
                   "kwargs": {"size": [PATCH, PATCH], "ratio": 2}}]
    if loaded_path:
        cfg.main.loaded_path = str(loaded_path)
    return cfg


def _epochs(saved):
    return [int(line.split(",")[0].split(":")[1]) for line in
            (saved / "log" / "metrics.jsonl").read_text().splitlines()]


def _adam_steps(trainer):
    return {float(s["step"]) for s in trainer.optimizer.state.values()}


def test_main_trains_a_device_config_and_resumes(tree, tmp_path):
    """The EDSR device config (bf16 compute, ``fused_tail``) shrunk: two
    epochs through ``vsr_tpu_torch.main``, then a third from the epoch-2
    checkpoint."""
    saved = tmp_path / "run"
    path = tmp_path / "cfg.yaml"
    save_config(_config(tree, saved), path)
    port_main.main([str(path), "--device", "cpu"])
    assert _epochs(saved) == [1, 2]
    assert (saved / "checkpoints" / "model_2.ckpt").exists()
    resumed = port_main.run_train(
        _config(tree, tmp_path / "resumed", num_epochs=3,
                loaded_path=saved / "checkpoints" / "model_2.ckpt"),
        device="cpu")
    assert _epochs(tmp_path / "resumed") == [3]
    assert _adam_steps(resumed) == {3.0 * STEPS}
    assert {p.dtype for p in resumed.net.parameters()} == {torch.float32}
    assert resumed.net.head.dtype == torch.bfloat16


def test_device_and_host_checkpoints_interchange(tree, tmp_path):
    port_main.run_train(_config(tree, tmp_path / "dev", num_epochs=1),
                        device="cpu")
    host = port_main.run_train(
        _config(tree, tmp_path / "host", "AcdcSISRTrainer", num_epochs=2,
                loaded_path=tmp_path / "dev" / "checkpoints" / "model_1.ckpt"),
        device="cpu")
    assert _epochs(tmp_path / "host") == [2]
    host_steps = len(host.train_dataloader)
    assert _adam_steps(host) == {float(STEPS + host_steps)}
    back = port_main.run_train(
        _config(tree, tmp_path / "dev2", num_epochs=3,
                loaded_path=tmp_path / "host" / "checkpoints" /
                "model_2.ckpt"), device="cpu")
    assert _epochs(tmp_path / "dev2") == [3]
    assert _adam_steps(back) == {float(2 * STEPS + host_steps)}
