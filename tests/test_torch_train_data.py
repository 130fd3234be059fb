"""Training slice, the data side: the port's config reader against
``yaml.safe_load`` on every config file, ``RngTree``, the transforms, the
datasets and the loader's batches bit-equal to ``vsr_tpu``'s on a synthetic
tree, the registry, the PNG writer and the checkpoint files."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests.synth import make_processed_tree
from vsr_tpu import config as jconfig
from vsr_tpu.callbacks import logger as jlogger
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data import transforms as jtransforms
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.preprocess import resize as jresize
from vsr_tpu.utils.recovery import find_latest_checkpoint as jax_find_latest
from vsr_tpu.utils.rng import RngTree as JaxRngTree
from vsr_tpu.utils.rng import seed_to_int as jax_seed_to_int
from vsr_tpu_torch import config
from vsr_tpu_torch.callbacks import logger
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.data import datasets, transforms
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.preprocess import resize
from vsr_tpu_torch.registry import build, get_class
from vsr_tpu_torch.utils import checkpoint
from vsr_tpu_torch.utils.recovery import find_latest_checkpoint
from vsr_tpu_torch.utils.rng import RngTree, seed_to_int

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))

# ------------------------------------------------------------------ config


@pytest.mark.parametrize("path", CONFIGS)
def test_config_reader_equals_safe_load(path, tmp_path):
    want = yaml.safe_load((REPO / path).read_text())
    got = config.load_config(REPO / path)
    assert isinstance(got, config.Config) and got.to_dict() == want
    # save_config round trip, read back by both readers.
    config.save_config(got, tmp_path / "c.yaml")
    assert config.load_config(tmp_path / "c.yaml").to_dict() == want
    assert yaml.safe_load((tmp_path / "c.yaml").read_text()) == want
    assert jconfig.load_config(tmp_path / "c.yaml").to_dict() == want


def test_config_finds_both_train_and_test_files():
    assert any(p.startswith("configs/train/") for p in CONFIGS)
    assert any(p.startswith("configs/test/") for p in CONFIGS)


SCALARS = """
a: 1e-4
b: 1.0e-4
c: [1, 2.5, 'x y', "q\\n", ~, yes, No, 0.0001, -3, +1_000]
d:
- x: 1
  y: {p: [1, {z: null}], q: {}}
- - 3
  - 4
-
  k: v # comment
e: 'it''s'
"f g": -.inf
h: {}
i: []
l: http://x/y   # a plain string with a colon
m: "a # b"
n: 1.
o: .5
p: {multi: 1,
    line: [2,
           3]}
q:
r: null
"""


def test_config_scalars_resolve_as_yaml_1_1():
    want = yaml.safe_load(SCALARS)
    got = config.loads(SCALARS)
    assert got == want
    assert got["a"] == "1e-4" and got["b"] == 1e-4  # no dot: a string
    text = config.dumps(got)
    assert config.loads(text) == want == yaml.safe_load(text)


def test_config_writer_round_trips_awkward_values():
    data = {"x": 1e-5, "y": 1e20, "s": "1e-4", "t": "true", "u": "", "v": " a",
            "w": "a: b", "n": None, "f": 0.1, "l": [[], {}, [1, [2]]],
            "p": "null", "q": "it's", "r": "a\nb", "path": "a/b c.nii.gz",
            "k": {"m": [{"name": "X", "kwargs": {"z": [1.5, 2]}}]}}
    text = config.dumps(data)
    assert yaml.safe_load(text) == data == config.loads(text)
    assert config.dumps({}) == "{}\n" and config.loads("") is None


@pytest.mark.parametrize("text,line", [
    ("a: &x 1", 1), ("a: 1\nb: *x", 2), ("a: !!int 1", 1), ("a: |\n  x", 1),
    ("a: >\n  x", 1), ("a: 1\n---\nb: 2", 2), ("a: b\n  c", 2),
    ("a: 0x1f", 1), ("\ta: 1", 1), ("a: [1, 2", 1), ("a: 'x", 1),
    ("a: 1\na: 2", 2), ("%YAML 1.1", 1), ("a: 010", 1), ("a: 1:30", 1)])
def test_config_reader_refuses_with_the_line_number(text, line):
    with pytest.raises(config.YamlError, match=f"line {line}"):
        config.loads(text)


def test_config_class_matches_the_original():
    data = {"main": {"saved_dir": "x"}, "l": [{"a": 1}], "n": {"k": {"j": 2}}}
    ours, theirs = config.Config(data), jconfig.Config(data)
    assert ours.to_dict() == theirs.to_dict() == data
    assert ours.n.k.j == 2 and ours.l[0].a == 1
    assert getattr(ours, "lr_scheduler", None) is None
    ours.main.x = {"y": 1}
    assert isinstance(ours.main.x, config.Config)
    assert ours.copy().to_dict() == ours.to_dict()


def test_load_config_refuses_a_non_mapping_and_reads_an_empty_file(tmp_path):
    (tmp_path / "l.yaml").write_text("- 1\n- 2\n")
    with pytest.raises(TypeError, match="mapping"):
        config.load_config(tmp_path / "l.yaml")
    (tmp_path / "e.yaml").write_text("# nothing\n")
    assert config.load_config(tmp_path / "e.yaml") == {}


# --------------------------------------------------------------------- rng


@pytest.mark.parametrize("seed", ["vsr", 0, 12345, "other"])
def test_rng_tree_numpy_draws_equal_jax(seed):
    assert seed_to_int(seed) == jax_seed_to_int(seed)
    ours, theirs = RngTree(seed), JaxRngTree(seed)
    for tokens in (("shuffle", 3), ("data", 2, 17), ("init",)):
        np.testing.assert_array_equal(
            ours.numpy_generator(*tokens).random(5),
            theirs.numpy_generator(*tokens).random(5))


def test_rng_tree_torch_generator_is_deterministic():
    a = torch.rand(4, generator=RngTree("vsr").torch_generator("init"))
    b = torch.rand(4, generator=RngTree("vsr").torch_generator("init"))
    c = torch.rand(4, generator=RngTree("vsr2").torch_generator("init"))
    d = torch.rand(4, generator=RngTree("vsr").torch_generator("train", 1))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


# -------------------------------------------------------------- transforms

AUGMENTS = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
            {"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": 2}}]
TRANSFORMS = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
              {"name": "ToTensor"}]


@pytest.mark.parametrize("specs,ndim", [
    (AUGMENTS, 3), (TRANSFORMS, 3),
    ([{"name": "RandomCrop", "kwargs": {"size": [5, 7]}}], 3),
    ([{"name": "RandomCrop", "kwargs": {"size": [5, 7, 2]}}], 4),
    ([{"name": "RandomCropPatch", "kwargs": {"size": [4, 4, 2], "ratio": 2}}], 4),
    ([{"name": "Normalize"}], 3),
    ([{"name": "RandomElasticDeformation", "kwargs": {"prob": 1.0}}], 3),
    ([{"name": "Resize", "kwargs": {"size": [9, 11]}}], 3),
    (None, 3)])
def test_transforms_equal_jax_on_the_same_draws(rng, specs, ndim):
    same_size = specs and specs[0]["name"] in ("RandomCrop",
                                               "RandomElasticDeformation")
    lr_shape = (12, 12, 1) if ndim == 3 else (12, 12, 4, 1)
    hr_shape = lr_shape if same_size else (24, 24) + lr_shape[2:]
    imgs = (rng.random(lr_shape).astype(np.float32) * 255,
            rng.random(hr_shape).astype(np.float32) * 255)
    for draw in range(3):
        got = transforms.compose(specs)(
            *imgs, rng=RngTree("vsr").numpy_generator("data", draw))
        want = jtransforms.compose(specs)(
            *imgs, rng=JaxRngTree("vsr").numpy_generator("data", draw))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_resize_bicubic_copy_is_bit_equal(rng):
    img = rng.random((10, 14, 2)).astype(np.float32)
    np.testing.assert_array_equal(resize.resize_bicubic(img, 7, 21),
                                  jresize.resize_bicubic(img, 7, 21))


def test_random_transform_without_rng_raises():
    with pytest.raises(ValueError, match="rng="):
        transforms.RandomCrop([2, 2])(np.zeros((4, 4, 1), np.float32))


# ------------------------------------------------- datasets and the loader


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_processed_tree(tmp_path_factory.mktemp("tree"), hr_size=24,
                               frames=6, patients_per_type=2, slices=2)


DATASETS = [
    ("AcdcSISRDataset", "imgs", {}),
    ("AcdcMISRDataset", "videos", {"num_frames": 5}),
    ("AcdcMISRDataset", "videos", {"num_frames": 4, "temporal_order": "last"}),
    ("AcdcVSRDataset", "videos", {"num_frames": 3}),
    ("Dsb15SISRDataset", "imgs", {}),
    ("Dsb15MISRDataset", "videos", {"num_frames": 3, "cache_decoded": True}),
    ("Dsb15VSRDataset", "videos", {"num_frames": 7,
                                   "temporal_order": "middle"}),
]


def _pair(name, sub, kwargs, tree, type_):
    kw = dict(data_dir=tree / sub, type=type_, downscale_factor=2,
              transforms=TRANSFORMS, augments=AUGMENTS, **kwargs)
    return (get_class("dataset", name)(**kw), getattr(jdatasets, name)(**kw))


def _assert_same_batches(ours, theirs):
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        n += 1
    return n


@pytest.mark.parametrize("name,sub,kwargs", DATASETS)
def test_loader_batches_equal_jax_for_two_epochs(tree, name, sub, kwargs):
    ours_ds, theirs_ds = _pair(name, sub, kwargs, tree, "train")
    assert len(ours_ds) == len(theirs_ds) > 0
    assert ours_ds.sample_name(1) == theirs_ds.sample_name(1)
    kw = dict(batch_size=5, shuffle=True, num_workers=2)
    ours, theirs = Dataloader(ours_ds, **kw), JaxDataloader(theirs_ds, **kw)
    assert len(ours) == len(theirs)
    for epoch in (1, 2):
        n = _assert_same_batches(ours.epoch(RngTree("vsr"), epoch),
                                 theirs.epoch(JaxRngTree("vsr"), epoch))
        assert n == len(ours)
    # The resumed tail of an epoch is the same batches.
    _assert_same_batches(ours.epoch(RngTree("vsr"), 2, skip=2),
                         theirs.epoch(JaxRngTree("vsr"), 2, skip=2))
    # Another seed shuffles and augments differently.
    a = next(ours.epoch(RngTree("vsr"), 1))
    b = next(ours.epoch(RngTree("other"), 1))
    assert not np.array_equal(a["index"], b["index"])


@pytest.mark.parametrize("name,sub,kwargs", DATASETS[:1] + DATASETS[3:4])
def test_validation_batches_equal_jax(tree, name, sub, kwargs):
    ours_ds, theirs_ds = _pair(name, sub, kwargs, tree, "valid")
    ours = Dataloader(ours_ds, batch_size=1, drop_last=True)
    theirs = JaxDataloader(theirs_ds, batch_size=1, drop_last=True)
    assert _assert_same_batches(iter(ours), iter(theirs)) == len(theirs_ds)


def test_dataset_and_loader_refusals(tree):
    kw = dict(data_dir=tree / "imgs", type="train", downscale_factor=2,
              transforms=None)
    with pytest.raises(NotImplementedError, match="native_decode"):
        datasets.AcdcSISRDataset(native_decode=True, **kw)
    with pytest.raises(ValueError, match="downscale factor"):
        datasets.AcdcSISRDataset(**{**kw, "downscale_factor": 5})
    with pytest.raises(ValueError, match="type should be"):
        datasets.AcdcSISRDataset(**{**kw, "type": "all"})
    with pytest.raises(ValueError, match="exceeds sequence length"):
        datasets.AcdcVSRDataset(**{**kw, "data_dir": tree / "videos"},
                                num_frames=9)
    ds = datasets.AcdcSISRDataset(**kw)
    with pytest.raises(NotImplementedError, match="host_shard"):
        Dataloader(ds, host_shard=True)
    with pytest.raises(ValueError, match="shuffle=True"):
        next(iter(Dataloader(ds, shuffle=True)))
    # Ported since the volumetric slice.
    assert get_class("dataset", "AcdcVolumeDataset") is datasets.AcdcVolumeDataset


def test_window_helpers_equal_jax():
    seq = np.arange(2 * 7).reshape(1, 2, 7).astype(np.float32)
    for order in ("last", "middle"):
        for n in (3, 4, 5):
            for t in range(7):
                np.testing.assert_array_equal(
                    datasets.extract_window(seq, t, n, order),
                    jdatasets.extract_window(seq, t, n, order))
    p = Path("patient001_2d_slice01_frame02.nii.gz")
    assert datasets.parse_sample_name(p) == jdatasets.parse_sample_name(p)


# ------------------------------------------- registry, monitor, recovery


def test_registry_builds_with_positional_arguments(tree):
    ds = build("dataset", {"name": "AcdcSISRDataset", "kwargs": {
        "data_dir": str(tree / "imgs"), "downscale_factor": 2,
        "transforms": TRANSFORMS}}, type="valid")
    loader = build("loader", {"name": "Dataloader", "kwargs": {"shuffle": False}},
                   ds, batch_size=3)
    assert loader.dataset is ds and loader.batch_size == 3
    with pytest.raises(KeyError, match="No 'trainer' named"):
        get_class("trainer", "NoSuchTrainer")
    for category in ("dataset", "transform", "loader", "loss", "metric",
                     "optimizer", "lr_scheduler", "logger", "monitor",
                     "trainer", "net"):
        with pytest.raises(KeyError):
            get_class(category, "__nothing__")


def test_monitor_copy_behaves_as_the_original(tmp_path):
    for mode, scores in (("min", [3.0, 2.0, 2.5, 2.6, 1.0]),
                         ("max", [1.0, 1.0, 0.5, 2.0])):
        kw = dict(checkpoints_dir=tmp_path / mode, mode=mode, target="Loss",
                  saved_freq=2, early_stop=2)
        ours, theirs = Monitor(**kw), JaxMonitor(**kw)
        for epoch, s in enumerate(scores, 1):
            assert ours.is_saved(epoch) == theirs.is_saved(epoch)
            assert ours.is_best({"Loss": s}) == theirs.is_best({"Loss": s})
            assert ours.is_early_stopped() == theirs.is_early_stopped()
            assert ours.state_dict() == theirs.state_dict()
        fresh = Monitor(**kw)
        fresh.load_state_dict(ours.state_dict())
        assert fresh.best == ours.best
    with pytest.raises(ValueError, match="mode"):
        Monitor(tmp_path, "avg", "Loss", 1)


def test_find_latest_checkpoint_copy(tmp_path):
    assert find_latest_checkpoint(tmp_path / "none") is None
    for name in ("model_best.ckpt", "model_2.ckpt", "model_10.ckpt",
                 "model_x.ckpt"):
        (tmp_path / name).write_bytes(b"x")
        assert find_latest_checkpoint(tmp_path) == jax_find_latest(tmp_path)
    assert find_latest_checkpoint(tmp_path).name == "model_10.ckpt"
    (tmp_path / "model_preempt.ckpt").write_bytes(b"x")
    assert find_latest_checkpoint(tmp_path).name == "model_preempt.ckpt"
    assert find_latest_checkpoint(tmp_path) == jax_find_latest(tmp_path)


# ------------------------------------------------- PNG grid, checkpoints


@pytest.mark.parametrize("n,channels", [(2, 1), (10, 1), (3, 3)])
def test_png_writer_decodes_to_the_uint8_grid(rng, tmp_path, n, channels):
    pairs = [rng.standard_normal((9, 7, channels)).astype(np.float32)
             for _ in range(n)]
    want = jlogger._to_uint8_grid(pairs)
    np.testing.assert_array_equal(logger._to_uint8_grid(pairs), want)
    logger.write_png(tmp_path / "g.png", want)
    with Image.open(tmp_path / "g.png") as img:
        assert img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img), want)
    with pytest.raises(ValueError, match="uint8"):
        logger.write_png(tmp_path / "bad.png", want.astype(np.float32))


def test_logger_writes_jsonl_and_grid_and_raises_on_a_bad_grid(rng, tmp_path):
    log = build("logger", {"name": "AcdcVSRLogger"}, log_dir=tmp_path / "log")
    batch = {"hr_imgs": rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)}
    outs = rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
    log.write(1, {"Loss": 1.0}, batch, outs, {"Loss": 2.0}, batch, outs)
    want = jlogger._to_uint8_grid(
        [img for t, o in zip(batch["hr_imgs"][:, -1], outs[:, -1])
         for img in (t, o)])
    with Image.open(tmp_path / "log" / "images" / "epoch_00001.png") as img:
        np.testing.assert_array_equal(np.asarray(img), want)
    import json
    rec = json.loads((tmp_path / "log" / "metrics.jsonl").read_text())
    assert rec == {"epoch": 1, "train": {"Loss": 1.0}, "valid": {"Loss": 2.0}}
    with pytest.raises(KeyError):  # a grid that cannot be made raises
        log.write(2, {"Loss": 1.0}, {}, outs, {"Loss": 2.0}, {}, outs)
    log.close()
    for name in ("AcdcSISRLogger", "Dsb15SISRLogger", "Dsb15VSRLogger"):
        assert issubclass(get_class("logger", name), logger.BaseLogger)
    with pytest.raises(TypeError):
        logger.SISRLogger(tmp_path / "l2", unknown=1)


def test_checkpoint_round_trip_is_atomic_and_weights_only(tmp_path):
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    net(torch.ones(1, 3)).sum().backward()
    opt.step()
    aux = {"epoch": 3, "monitor": {"best": None, "best_sign": 1,
                                   "not_improved_count": 0},
           "lr_scheduler": None, "random_seed": "vsr",
           "mid_epoch": {"steps_done": 2, "count": 8.0,
                         "acc": {"Loss": 1.5}, "batches_total": 5}}
    path = tmp_path / "ck" / "model_3.ckpt"
    checkpoint.save_checkpoint(path, {"net": net.state_dict(),
                                      "optimizer": opt.state_dict()}, aux)
    assert [p.name for p in path.parent.iterdir()] == ["model_3.ckpt"]
    raw = torch.load(path, weights_only=True)
    assert raw["format"] == "vsr_tpu_torch-v1"
    assert sorted(raw) == ["aux", "format", "net", "optimizer"]
    state, got_aux = checkpoint.load_checkpoint(path)
    assert got_aux == aux
    for k, v in net.state_dict().items():
        assert torch.equal(state["net"][k], v)
    fresh = torch.optim.Adam(torch.nn.Linear(3, 2).parameters(), lr=1.0)
    fresh.load_state_dict(state["optimizer"])
    assert fresh.param_groups[0]["lr"] == 1e-3


def test_checkpoint_refuses_a_flax_msgpack_file(rng, tmp_path):
    from flax import serialization

    path = tmp_path / "model_1.ckpt"
    path.write_bytes(serialization.msgpack_serialize(
        {"params": {"w": rng.standard_normal((2, 2)).astype(np.float32)}}))
    with pytest.raises(ValueError, match="flax msgpack"):
        checkpoint.load_checkpoint(path)
    torch.save({"format": "other"}, tmp_path / "t.ckpt")
    with pytest.raises(ValueError, match="not a vsr_tpu_torch-v1"):
        checkpoint.load_checkpoint(tmp_path / "t.ckpt")
