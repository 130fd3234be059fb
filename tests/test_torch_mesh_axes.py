"""The ``model`` and ``expert`` mesh axes and ``--mesh`` serving of the port
(``vsr_tpu_torch/parallel/{mesh,serving,tp,ep,placement}.py``) against
``vsr_tpu`` on the same meshes.

The JAX side runs on the 8 host devices of ``tests/conftest.py``; the port
side on gloo ranks on the CPU, one ``torch.multiprocessing.spawn`` for each
world size (``tests/_torch_parallel_worker.spawn``, the jobs in
``tests/_torch_mesh_worker.py``). Weights are flax variables drawn with
numpy (``tests/_torch_parity.init``) and cross over through
``vsr_tpu_torch/interop.py``. Tolerances are JAX's own:

- serving under ``model``: ``(diff > 1).mean() == 0``
  (``tests/test_tensor_parallel.py``); under ``expert``: within one grey
  and < 1 % of pixels different (``tests/test_expert_parallel.py``); W8A8
  under ``data``: within one grey and > 99 % equal to the run without a
  mesh (``tests/test_infer_sharded.py``);
- training: each step's loss ``rtol`` 2e-4 / ``atol`` 1e-5, the parameters
  ``rtol`` 5e-4 / ``atol`` 1e-5 (``tests/test_expert_parallel.py``).

Each rank's split leaves hold 1/axis of the parameter and of its Adam
moments; the replicated leaves are bitwise equal on every rank.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from tests._torch_cases import run_cases, subdir
from tests._torch_parallel_worker import TASKS, spawn
from tests._torch_parity import init, randomize
from tests.synth import make_processed_tree
from tests.test_torch_parallel import _jax_run
from vsr_tpu import models as jmodels
from vsr_tpu.infer import make_pipeline as jmake_pipeline
from vsr_tpu.parallel.ep import expert_partition_specs
from vsr_tpu.parallel.mesh import make_mesh as jmake_mesh
from vsr_tpu.parallel.serving import parse_mesh_axes as jparse_mesh_axes
from vsr_tpu.parallel.tp import model_partition_specs
from vsr_tpu_torch import infer, models, serve
from vsr_tpu_torch.interop import from_jax_tree
from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
from vsr_tpu_torch.parallel import ep, tp
from vsr_tpu_torch.parallel.mesh import Mesh
from vsr_tpu_torch.parallel.serving import parse_mesh_axes

WORKER = "tests._torch_mesh_worker:"
EDSR = dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=8,
            upscale_factor=2)
DRF = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
           upscale_factor=2, fused_squeeze=True)
MOE = dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=8,
           upscale_factor=2, num_experts=4, group_size=16, moe_every=1)
STEPS = 3
# Adam's eps at 1e-5: with 1e-8 a gradient near eps (a clipped one, or a
# bias's noise) turns float noise into a step (ROADMAP.md, queue 3).
OPT = ("Adam", {"lr": 1e-3, "eps": 1e-5})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=32,
                               frames=7, patients_per_type=1, slices=1)


def _variables(name, kwargs, x, seed=0):
    net = getattr(jmodels, name)(**kwargs)
    return net, randomize(init(net, x, seed=seed),
                          np.random.default_rng(seed))


def _frames(n, seed, side=24):
    return np.round(np.random.default_rng(seed).random((n, side, side))
                    * 255).astype(np.float32)


def _flat_paths(specs, axis) -> set:
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(k.key for k in path) for path, spec in leaves
            if axis in tuple(spec)}


def _raised(fn, exc=Exception) -> str:
    try:
        fn()
    except exc as err:
        return str(err)
    raise AssertionError(f"{fn} did not raise")


# ------------------------------------------------------------- no spawn


def _case_parse_mesh_axes():
    for spec in ("data=2,spatial=4", "data=-1", " data = 3 ",
                 "model=2", "data=2,expert=2"):
        assert parse_mesh_axes(spec) == jparse_mesh_axes(spec)
    for spec in ("data", "dta=2", " , "):
        assert _raised(lambda: parse_mesh_axes(spec), ValueError) == \
            _raised(lambda: jparse_mesh_axes(spec), ValueError)


def _case_split_leaf_sets():
    x4 = np.zeros((1, 8, 8, 1), np.float32)
    x5 = np.zeros((1, 2, 8, 8, 1), np.float32)
    drf_moe = dict(DRF, num_experts=4, expert_group_size=16)
    jmesh = {a: jmake_mesh({a: 2}, devices=jax.devices()[:2])
             for a in ("model", "expert")}
    for name, kwargs, x in (("DRFNet", DRF, x5), ("EDSRNet", EDSR, x4),
                            ("MoEEDSRNet", MOE, x4),
                            ("DRFNet", drf_moe, x5)):
        jnet, variables = _variables(name, kwargs, x)
        net = getattr(models, name)(**kwargs)
        want = _flat_paths(model_partition_specs(variables, jmesh["model"]),
                           "model")
        got = {path for path, _, _ in tp.model_leaves(net, 2)}
        assert got == want, (name, got ^ want)
        want = _flat_paths(expert_partition_specs(variables,
                                                  jmesh["expert"]), "expert")
        got = {path for path, _, shape in ep.expert_leaves(net)
               if ep.expert_spec(path.rsplit("/", 1)[-1], shape, 2) == 0}
        assert got == want, (name, got ^ want)
    dims = {n: d for _, n, d in tp.model_leaves(models.DRFNet(**DRF), 2)}
    assert dims["step.fblock.deconvs.0.weight"] == 1  # (in, out, k, k)
    assert dims["step.fblock.convs.1.weight"] == 0  # K1's (F, K)
    assert "step.fblock.prelus.0.weight" not in dims  # one alpha
    assert "step.out_block.tail.conv.weight" not in dims  # cout 1


def _jax_trainer_error(mesh_axes, **knobs):
    from vsr_tpu.losses import L1Loss
    from vsr_tpu.metrics import PSNR
    from vsr_tpu.optim import Adam
    from vsr_tpu.runner.trainers import AcdcSISRTrainer

    return _raised(lambda: AcdcSISRTrainer(
        train_dataloader=None, valid_dataloader=None,
        net=jmodels.EDSRNet(**EDSR), loss_fns=[L1Loss()],
        loss_weights=[1.0], metric_fns=[PSNR()], optimizer=Adam(lr=1e-3),
        lr_scheduler=None, logger=None, monitor=None, num_epochs=1,
        mesh_axes=mesh_axes, **knobs))


def _case_trainer_refusals():
    from vsr_tpu_torch.parallel.placement import check_exclusive
    from vsr_tpu_torch.runner.trainers import build_data_parallel

    for axes, knobs in (({"data": 2, "model": 2}, {"zero_optim": True}),
                        ({"data": 2, "model": 2}, {"fsdp": True}),
                        ({"data": 2, "expert": 2}, {"zero_optim": True}),
                        ({"data": 2, "expert": 2}, {"fsdp": True}),
                        ({"expert": 2, "model": 2}, {}),
                        ({"expert": 2, "spatial": 2}, {}),
                        ({"data": 2, "spatial": 2, "model": 2}, {})):
        got = _raised(lambda: build_data_parallel(
            axes, context="AcdcSISRTrainer", **knobs))
        assert got == _jax_trainer_error(axes, **knobs), (axes, knobs, got)
    assert "mutually exclusive" in _raised(
        lambda: check_exclusive({"model": 2, "expert": 2}))


def _case_device_trainer_refusals():
    from vsr_tpu.losses import L1Loss
    from vsr_tpu.metrics import PSNR
    from vsr_tpu.optim import Adam
    from vsr_tpu.registry import get_class as jget_class
    from vsr_tpu_torch.registry import get_class

    jcls = jget_class("trainer", "AcdcSISRDeviceTrainer")
    cls = get_class("trainer", "AcdcSISRDeviceTrainer")
    for axes in ({"model": 2}, {"data": 1, "expert": 2}):
        want = _raised(lambda: jcls(
            train_dataloader=None, valid_dataloader=None,
            net=jmodels.MoEEDSRNet(**MOE), loss_fns=[L1Loss()],
            loss_weights=[1.0], metric_fns=[PSNR()],
            optimizer=Adam(lr=1e-3), lr_scheduler=None, logger=None,
            monitor=None, num_epochs=1, mesh_axes=axes, patch=4, ratio=2))
        got = _raised(lambda: cls(net=None, mesh_axes=axes, patch=4,
                                  ratio=2), NotImplementedError)
        assert got == want, axes


def _case_expert_refusals():
    from vsr_tpu.parallel import ep as jep

    jmesh = jmake_mesh({"data": 2, "expert": 2}, devices=jax.devices()[:4])
    mesh = Mesh(("data", "expert"), {"data": 2, "expert": 2}, 0)
    x4 = np.zeros((1, 8, 8, 1), np.float32)
    for name, kwargs, impl in (
            ("EDSRNet", dict(EDSR), "sparse"),
            ("MoEEDSRNet", dict(MOE, dispatch_impl="dense_nhwc"),
             "dense_nhwc"),
            ("MoEEDSRNet", dict(MOE), None),
            ("MoEEDSRNet", dict(MOE, num_experts=3), "sparse")):
        _, variables = _variables(name, kwargs, x4)
        net = getattr(models, name)(**kwargs)
        want = _raised(lambda: jep.validate_expert_mesh(
            jmesh, variables, context="c", exc=ValueError,
            dispatch_impl=impl), ValueError)
        got = _raised(lambda: ep.validate_expert_mesh(
            mesh, net, context="c", exc=ValueError, dispatch_impl=impl),
            ValueError)
        assert got == want, (name, impl)
    assert ep.resolve_dispatch_impl(models.DRFNet(**DRF)) == \
        jep.resolve_dispatch_impl(jmodels.DRFNet(**DRF))
    assert ep.resolve_dispatch_impl(models.MoEEDSRNet(
        **dict(MOE, dispatch_impl="dense"))) == "dense"


def _case_serving_refusals(tmp_path):
    net = models.EDSRNet(**EDSR)
    jnet, variables = _variables("EDSRNet", EDSR,
                                 np.zeros((1, 12, 12, 1), np.float32))
    data2 = Mesh(("data",), {"data": 2}, 0)
    want = _raised(lambda: jmake_pipeline(
        jnet, variables, 2, "acdc", w8a8=True,
        mesh=jmake_mesh({"data": 2}, devices=jax.devices()[:2])),
        ValueError)
    assert _raised(lambda: infer.make_pipeline(net, 2, "acdc", w8a8=True,
                                               mesh=data2)) == want
    assert "whole sequences" in _raised(lambda: infer.make_pipeline(
        models.DRFNet(**DRF), 2, "acdc", video_t=4, mesh=data2)(
            torch.zeros(10, 24, 24)), ValueError)
    with pytest.raises(NotImplementedError, match="'spatial' and 'model'"):
        infer.make_pipeline(net, 2, "acdc", mesh=Mesh(
            ("spatial", "model"), {"spatial": 2, "model": 2}, 0))
    with pytest.raises(ValueError, match="no expert-stacked"):
        infer.make_pipeline(net, 2, "acdc",
                            mesh=Mesh(("expert",), {"expert": 2}, 0))
    with pytest.raises(NotImplementedError, match="item 6"):
        infer.make_pipeline(models.Volume3DSRNet(
            in_channels=1, out_channels=1, num_features=4, num_resblocks=1,
            upscale_factor=2), 2, "acdc", volume=("3d", 3), mesh=data2)
    src = tmp_path / "raw" / "p"
    src.mkdir(parents=True)
    save_nifti(_frames(6, 1).reshape(24, 24, 2, 3), src / "p_4d.nii")
    base = [str(tmp_path / "raw"), str(tmp_path / "o"), "--device", "cpu"]
    for argv, match in (
            (["--chunk", "2", "--mesh", "data=1"], "mutually exclusive"),
            (["--mesh", "data=2"], "--mesh: Mesh needs 2 devices, have 1"),
            (["--mesh", "spatial=1"], "'spatial' is not yet ported"),
            (["--net", "Volume3DSRNet", "--mesh", "data=1"], "item 6")):
        with pytest.raises(SystemExit, match=match):
            infer.run(infer.parse_args(base + argv))
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve.main(["--device", "cpu", "--mesh", "data=1", "--chunk", "2"])


def _case_mesh_refusals():
    from vsr_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"model": -1})
    assert mesh.shape == {"model": 1} and mesh.groups == {}
    assert mesh.coord("model") == mesh.coord("data") == 0
    for axis in ("spatial", "seq", "pipe"):
        with pytest.raises(NotImplementedError, match=f"'{axis}'.*item 6"):
            make_mesh({axis: 1})
    grid = Mesh(("data", "model"), {"data": 2, "model": 2}, 3)
    assert (grid.coord("data"), grid.coord("model")) == (1, 1)
    assert Mesh(("data", "model"), {"data": 2, "model": 2}, 1).coord(
        "model") == 1  # row-major, as the JAX mesh's reshape


def test_mesh_axes_rules_and_refusals(tmp_path):
    run_cases([
        ("parse_mesh_axes", _case_parse_mesh_axes),
        ("split leaves as in JAX", _case_split_leaf_sets),
        ("trainer refusals in JAX's words", _case_trainer_refusals),
        ("device trainer refusals", _case_device_trainer_refusals),
        ("expert refusals", _case_expert_refusals),
        ("serving refusals", lambda: _case_serving_refusals(
            subdir(tmp_path, "serving"))),
        ("mesh refusals and layout", _case_mesh_refusals),
    ])


# ------------------------------------------------------------ the ranks


def _serve_cases(world):
    """(port cases for the ranks, JAX outputs by case name)."""
    jdev = jax.devices()
    x4 = np.zeros((1, 12, 12, 1), np.float32)
    x5 = np.zeros((1, 2, 12, 12, 1), np.float32)
    if world == 2:
        specs = [("edsr model", "EDSRNet", EDSR, x4, {"model": 2}, 5, {}),
                 ("drf video model", "DRFNet", DRF, x5, {"model": 2}, 12,
                  {"video_t": 4}),
                 ("drf video data", "DRFNet", DRF, x5, {"data": 2}, 12,
                  {"video_t": 4})]
        for dispatch in ("sparse", "dense"):
            for router in ("rank", "rank_pallas"):
                specs.append((f"moe expert {dispatch} {router}",
                              "MoEEDSRNet", dict(MOE, dispatch_impl=dispatch,
                                                 router_impl=router), x4,
                              {"expert": 2}, 5, {}))
        specs.append(("moe expert int8", "MoEEDSRNet", MOE, x4,
                      {"expert": 2}, 5, {"int8": True}))
    else:
        specs = [("edsr data model", "EDSRNet", EDSR, x4,
                  {"data": 2, "model": 2}, 5, {}),
                 ("drf video data model", "DRFNet", DRF, x5,
                  {"data": 2, "model": 2}, 12, {"video_t": 4}),
                 ("moe data expert", "MoEEDSRNet", MOE, x4,
                  {"data": 2, "expert": 2}, 5, {})]
    cases, want = [], {}
    for i, (name, net, kwargs, x, axes, n, extra) in enumerate(specs):
        jnet, variables = _variables(net, kwargs, x, seed=i)
        frames = _frames(n, i)
        jmesh = jmake_mesh(axes, devices=jdev[:int(np.prod(list(
            axes.values())))])
        jkw = {k: v for k, v in extra.items()}
        want[name] = jax.tree_util.tree_map(np.asarray, jmake_pipeline(
            jnet, variables, 2, "acdc", mesh=jmesh, **jkw)(frames))
        cases.append(dict(name=name, net=net, kwargs=kwargs,
                          weights=jax.tree_util.tree_map(np.asarray,
                                                         variables),
                          axes=axes, frames=frames, **extra))
    return cases, want


def _w8a8_case():
    """EDSR (16 features, eligible) with static scales calibrated on the
    served frames' net input: the port's data=2 pipeline, and the same
    pipeline without a mesh."""
    from vsr_tpu_torch.interop import load_jax_params
    from vsr_tpu_torch.quantize import calibrate_w8a8

    kwargs = dict(EDSR, num_features=16)
    _, variables = _variables("EDSRNet", kwargs,
                              np.zeros((1, 12, 12, 1), np.float32), seed=9)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    net = models.EDSRNet(**kwargs)
    load_jax_params(net, variables)
    frames = _frames(5, 9)
    z = infer.make_prep(2, "acdc")(torch.from_numpy(frames))[1]
    scales = calibrate_w8a8(net.eval(), [z])
    assert scales
    ref = infer.make_pipeline(net, 2, "acdc", w8a8=scales)(
        torch.from_numpy(frames))[1].numpy()
    return (dict(name="edsr data w8a8", net="EDSRNet", kwargs=kwargs,
                 weights=variables, axes={"data": 2}, frames=frames,
                 w8a8=scales), ref)


def _hold_model(got, want, what):
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    assert (diff > 1).mean() == 0, (what, diff.max())


def _hold_expert(got, want, what):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=1.0, err_msg=what)
    assert np.mean(got != want) < 0.01, what


def _case_serving(results, want, world):
    got = _check(results["serve"])
    for name, (lr, sr) in want.items():
        hold = _hold_expert if "expert" in name else _hold_model
        hold(got[name]["sr"], sr, name)
        np.testing.assert_allclose(got[name]["lr"], lr, atol=1e-3,
                                   err_msg=name)
    if world == 2:
        shapes = got["moe expert int8"]["shapes"]
        for rank_shapes in shapes:  # the int8 net keeps its stacks split
            assert rank_shapes["moes.0.expert_wi"] == (2, 8, 16)
        edsr = got["edsr model"]["shapes"][1]
        assert edsr["blocks.0.convs.0.weight"] == (4, 8, 3, 3)
        assert edsr["tail.conv.weight"] == (1, 8, 3, 3)  # cout 1


def _check(result):
    assert "error" not in result, result.get("error")
    return result


def _jax_runs(tree, jax_dir, runs, knobs):
    return {what: _jax_run(task, tree, subdir(jax_dir, what.replace(
        " ", "_")), epochs=STEPS, opt=OPT,
        mesh_axes=axes, **knobs.get(what, {}))
        for what, (task, axes) in runs.items()}


def _train_jobs(tree, want, runs, tmp_path, knobs, checkpoints=()):
    return [(what, WORKER + "train", dict(
        task=task, tree=tree, weights=want[what]["initial"],
        out=str(subdir(tmp_path, what.replace(" ", "_"))), axes=axes,
        epochs=STEPS, opt=OPT, checkpoints=what in checkpoints,
        knobs=knobs.get(what, {})))
        for what, (task, axes) in runs.items()]


def _case_training(results, want, what, task, axes):
    got = _check(results[what])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=1e-5, err_msg=what)
    net = getattr(models, TASKS[task]["net"])(**TASKS[task]["net_kwargs"])
    flax = from_jax_tree(net, want["final"])
    for name, value in got["state"].items():
        np.testing.assert_allclose(value, flax[name], rtol=5e-4, atol=1e-5,
                                   err_msg=f"{what}: {name}")
    axis = "model" if "model" in axes else "expert"
    split = ({n: d for _, n, d in tp.model_leaves(net, axes[axis])}
             if axis == "model" else
             {n: 0 for _, n, s in ep.expert_leaves(net)})
    assert split
    full = {n: p.shape for n, p in net.named_parameters()}
    ranks = got["ranks"]
    groups = got["ranks_groups"]
    for r, rank in enumerate(ranks):
        for name, value in rank["params"].items():
            shape = list(full[name])
            if name in split:  # 1/axis of the parameter and its moments
                shape[split[name]] //= axes[axis]
            assert value.shape == tuple(shape), (what, r, name)
            assert set(rank["moments"][name].values()) == {tuple(shape)}, (
                what, r, name)
    for r, rank in enumerate(ranks):
        for s, other in enumerate(ranks):
            same_block = groups[r][axis] == groups[s][axis]
            for name, value in rank["params"].items():
                if name not in split or same_block:
                    np.testing.assert_array_equal(
                        value, other["params"][name],
                        err_msg=f"{what}: {name} on ranks {r}, {s}")


def _flax_layout(value: np.ndarray, transform) -> np.ndarray:
    """A port leaf laid out as flax's (``interop``'s layout transforms are
    permutations: invert one by the indices it moves)."""
    from vsr_tpu_torch.interop import _KERNEL_LAYOUTS

    if transform not in _KERNEL_LAYOUTS:
        return value
    shape = _KERNEL_LAYOUTS[transform][1](value.shape)
    moved = transform(np.arange(value.size).reshape(shape))
    flat = np.empty(value.size, value.dtype)
    flat[moved.ravel()] = value.ravel()
    return flat.reshape(shape)


def _case_checkpoints(results, what, task):
    from vsr_tpu_torch.interop import module_slots
    from vsr_tpu_torch.utils.checkpoint import load_checkpoint

    got = _check(results[what])
    for key in ("gathered_restored", "sharded_restored", "consolidated"):
        assert got[key] == [], (key, got[key])
    assert got["shards"] == ["sharded.ckpt", "sharded.ckpt.shard0",
                             "sharded.ckpt.shard1"]
    # The gathered file holds the full leaves: laid out as flax's, they
    # run in vsr_tpu's net as they run in the port's.
    state = load_checkpoint(got["gathered"])[0]["net"]
    t = TASKS[task]
    net = getattr(models, t["net"])(**t["net_kwargs"])
    net.load_state_dict(state)
    names = {id(p): n for n, p in [*net.named_parameters(),
                                   *net.named_buffers()]}
    variables: dict = {}
    for path, tensor, transform in module_slots(net):
        cursor = variables
        for part in path[:-1]:
            cursor = cursor.setdefault(part, {})
        cursor[path[-1]] = _flax_layout(state[names[id(tensor)]].numpy(),
                                        transform)
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 8, 8, 1) if task == "drf" else (2, 8, 8, 1)).astype(np.float32)
    jnet = getattr(jmodels, t["net"])(**t["net_kwargs"])
    want = np.asarray(jnet.apply(variables, x))
    with torch.no_grad():  # channels first: (N, [T,] C, h, w)
        port = net.eval()(torch.from_numpy(np.moveaxis(x, -1, -3).copy()))
    np.testing.assert_allclose(np.moveaxis(port.numpy(), -3, -1), want,
                               rtol=1e-4, atol=1e-5)


def _infer_cli_job(tmp_path, world):
    src = tmp_path / "raw" / "p"
    src.mkdir(parents=True)
    save_nifti(_frames(6, 4).reshape(24, 24, 2, 3), src / "p_4d.nii")
    argv = [str(tmp_path / "raw"), str(tmp_path / "sr_ref"), "--device",
            "cpu", "--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR)]
    infer.main(argv)
    mesh_argv = argv[:1] + [str(tmp_path / "sr_mesh")] + argv[2:] + [
        "--mesh", "model=2" if world == 2 else "data=2,model=2"]
    return ("infer", WORKER + "infer_cli", dict(argv=mesh_argv))


def _case_infer_cli(results, tmp_path):
    assert _check(results["infer"])["frames"] == 6
    want = load_nifti(tmp_path / "sr_ref" / "p" / "p_4d_sr.nii.gz")
    got = load_nifti(tmp_path / "sr_mesh" / "p" / "p_4d_sr.nii.gz")
    _hold_model(got, want, "infer --mesh")


def _daemon_job():
    frames = _frames(5, 5)
    kwargs = dict(MOE, router_impl="rank_pallas")
    argv = ["--device", "cpu", "--port", "0", "--net", "MoEEDSRNet",
            "--net-kwargs", json.dumps(kwargs), "--frames-shape", "5,24,24",
            "--mesh", "expert=2"]
    net = infer.build_serving_net("MoEEDSRNet", kwargs, device="cpu")
    want = infer.make_pipeline(net, 2, "acdc")(torch.from_numpy(frames))[1]
    return ("daemon", WORKER + "daemon", dict(argv=argv, frames=frames,
                                               requests=2)), want.numpy()


def _case_daemon(results, want):
    got = _check(results["daemon"])
    assert len(got["responses"]) == 2
    for sr in got["responses"]:
        _hold_expert(sr, want, "serve --mesh expert=2")
    assert got["followed"] == 3  # the warm-up and two requests


def test_mesh_axes_two_ranks_match_jax(tree, tmp_path):
    runs = {"drf model": ("drf", {"model": 2}),
            "moe expert": ("moe", {"expert": 2})}
    # The clip's norm sums the split leaves' blocks over the axis.
    knobs = {"drf model": {"grad_clip": 0.05}}
    want = _jax_runs(tree, subdir(tmp_path, "jax"), runs, knobs)
    cases, served = _serve_cases(2)
    w8a8, w8a8_ref = _w8a8_case()
    cli_dir = subdir(tmp_path, "cli")
    daemon, daemon_want = _daemon_job()
    jobs = _train_jobs(tree, want, runs, tmp_path, knobs,
                       checkpoints=("drf model", "moe expert"))
    jobs += [("serve", WORKER + "serve", dict(cases=cases + [w8a8])),
             _infer_cli_job(cli_dir, 2), daemon]
    results = spawn(jobs, subdir(tmp_path, "spawn"), world=2)
    run_cases([
        ("serving against JAX's meshes", lambda: _case_serving(
            results, served, 2)),
        ("W8A8 static scales under data", lambda: _hold_model_w8a8(
            _check(results["serve"])["edsr data w8a8"]["sr"], w8a8_ref)),
        *[(f"{what} training against JAX", functools.partial(
            _case_training, results, want[what], what, *spec))
          for what, spec in runs.items()],
        *[(f"{what} checkpoints", functools.partial(
            _case_checkpoints, results, what, runs[what][0]))
          for what in runs],
        ("infer --mesh end to end", lambda: _case_infer_cli(results,
                                                            cli_dir)),
        ("serve --mesh expert=2", lambda: _case_daemon(results,
                                                       daemon_want)),
    ])


def _hold_model_w8a8(got, want):
    assert got.shape == want.shape == (5, 24, 24)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() > 0.99


def test_mesh_axes_four_ranks_match_jax(tree, tmp_path):
    runs = {"drf data model": ("drf", {"data": 2, "model": 2}),
            "moe data expert": ("moe", {"data": 2, "expert": 2})}
    want = _jax_runs(tree, subdir(tmp_path, "jax"), runs, {})
    cases, served = _serve_cases(4)
    jobs = _train_jobs(tree, want, runs, tmp_path, {})
    jobs.append(("serve", WORKER + "serve", dict(cases=cases)))
    results = spawn(jobs, subdir(tmp_path, "spawn"), world=4)
    run_cases([
        ("serving against JAX's meshes", lambda: _case_serving(
            results, served, 4)),
        *[(f"{what} training against JAX", functools.partial(
            _case_training, results, want[what], what, *spec))
          for what, spec in runs.items()],
    ])
