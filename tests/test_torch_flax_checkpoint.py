"""The port's flax checkpoint reader against ``vsr_tpu``: its own msgpack
decoder (``vsr_tpu_torch/utils/msgpack.py``) against flax's, a checkpoint
that ``vsr_tpu.utils.checkpoint.save_checkpoint`` wrote read leaf for leaf
(bit-equal, bfloat16 and chunked leaves included), the refusals (a sharded
checkpoint, resuming training), and a tiny DRFNet served from a flax
checkpoint by the port's infer CLI against ``vsr_tpu``'s pipeline on the
same file (>= 99.9 % exact grey, <= 1 grey)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import flax.serialization as flax_serialization
import vsr_tpu.infer as jinfer
from tests._torch_cases import run_cases, subdir
from tests._torch_parity import init, randomize
from vsr_tpu.models import DRFNet as JaxDRFNet
from vsr_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vsr_tpu_torch import infer
from vsr_tpu_torch.io import nifti
from vsr_tpu_torch.runner.trainers import BaseTrainer
from vsr_tpu_torch.utils import checkpoint, msgpack


def _assert_same_tree(want, got, path="") -> int:
    """Every leaf of flax's restore equals the port's, bit for bit (a
    bfloat16 leaf as its 16-bit patterns); returns the leaves compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), path
        return sum(_assert_same_tree(want[k], got[k], f"{path}/{k}")
                   for k in want)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        assert np.asarray(want).dtype.name == "bfloat16", path
        assert tuple(got.shape) == np.asarray(want).shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
        return 1
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))
        return 1
    assert type(got) is type(want) and got == want, (path, got, want)
    return 1


def _case_decoder_reads_every_type_flax_writes(monkeypatch):
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "bf16": jnp.linspace(-3, 3, 40, dtype=jnp.bfloat16),  # chunked too
        "empty": np.zeros((0, 3), np.int32),
        "empty_bf16": jnp.zeros((0,), jnp.bfloat16),
        "big": np.arange(100, dtype=np.float64),                # chunked
        "scalars": {"i64": np.int64(-7), "f32": np.float32(2.5),
                    "bf16": jnp.bfloat16(1.5)},
        "py": {"ints": [0, 1, 127, 128, -1, -32, -33, 255, 256, 65536,
                        -40000, 2 ** 40, -(2 ** 40)],
               "float": 3.25, "none": None, "true": True, "false": False,
               "str": "x" * 300, "utf8": "µs", "bytes": b"\x00\xff",
               "complex": 1 + 2j, "long": list(range(70000))},
        "many": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    got = msgpack.restore(data)
    assert _assert_same_tree(serialization.msgpack_restore(data), got) > 30
    with pytest.raises(ValueError, match="truncated"):
        msgpack.restore(data[:-3])
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack.restore(data + b"\x00")


def _jax_trainer_state():
    """The state a JAX trainer checkpoints: ``{"params": variables,
    "opt_state": optax state}``, DUF-like (params + batch_stats)."""
    rng = np.random.default_rng(0)
    variables = {
        "params": {"Conv_0": {"kernel": rng.standard_normal(
                       (3, 3, 1, 8)).astype(np.float32),
                              "bias": rng.standard_normal(8).astype(np.float32)},
                   "BatchNorm_0": {"scale": np.ones(8, np.float32),
                                   "bias": np.zeros(8, np.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": rng.standard_normal(8).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}},
    }
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adam(1e-3)).init(params)
    return {"params": variables, "opt_state": opt_state}


def _case_jax_trainer_checkpoint_reads_bit_equal(tmp_path, monkeypatch):
    state = _jax_trainer_state()
    state["params"]["params"]["head_bf16"] = jnp.asarray(
        np.random.default_rng(1).standard_normal((5, 7)), jnp.bfloat16)
    # A leaf over flax's chunk size: it is written as a chunked dict.
    state["params"]["params"]["Conv_0"]["kernel"] = np.random.default_rng(
        2).standard_normal((3, 3, 8, 16)).astype(np.float32)
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 1024)
    aux = {"epoch": 3, "monitor": {"best": 31.5, "mode": "max"},
           "lr_scheduler": {"last_epoch": 2}, "random_seed": "vsr"}
    path = tmp_path / "model_3.ckpt"
    jax_save_checkpoint(path, state, aux)
    assert b"__msgpack_chunked_array__" in path.read_bytes()

    got_state, got_aux = checkpoint.load_flax_checkpoint(path)
    want = serialization.msgpack_restore(path.read_bytes())
    assert _assert_same_tree(want["state"], got_state) >= 12
    assert got_aux == aux
    leaf = got_state["params"]["params"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        leaf, np.asarray(state["params"]["params"]["Conv_0"]["kernel"]))
    assert got_state["params"]["params"]["head_bf16"].dtype == torch.bfloat16


def _case_sharded_files_read_and_foreign_files_refused(tmp_path):
    from vsr_tpu.utils.checkpoint import (consolidate_sharded_checkpoint,
                                          is_sharded_checkpoint,
                                          save_checkpoint_sharded)

    main_file = tmp_path / "model_1.ckpt"
    # A sharded checkpoint (its main file and shard): read whole, as the
    # JAX package's consolidation gives it.
    state = _jax_trainer_state()
    save_checkpoint_sharded(main_file, state, {"epoch": 1})
    assert is_sharded_checkpoint(main_file)
    consolidate_sharded_checkpoint(main_file, tmp_path / "whole.ckpt")
    got_state, got_aux = checkpoint.load_flax_checkpoint(main_file)
    assert got_aux == {"epoch": 1}
    want = serialization.msgpack_restore((tmp_path / "whole.ckpt").read_bytes())
    assert _assert_same_tree(want["state"], got_state) >= 12
    bare = tmp_path / "bare.ckpt"
    bare.write_bytes(serialization.msgpack_serialize({"params": {}}))
    with pytest.raises(ValueError, match="flax msgpack file but not"):
        checkpoint.load_flax_checkpoint(bare)
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"\xc1 not msgpack")
    with pytest.raises(ValueError, match="neither"):
        checkpoint.load_flax_checkpoint(junk)


def _case_resuming_training_from_a_flax_checkpoint_is_refused(tmp_path):
    path = tmp_path / "model_1.ckpt"
    jax_save_checkpoint(path, _jax_trainer_state(), {"epoch": 1})
    trainer = BaseTrainer.__new__(BaseTrainer)  # load() reads first
    trainer.device = torch.device("cpu")
    with pytest.raises(ValueError, match="resuming training from it is "
                                         "refused"):
        trainer.load(path)


DRF_KW = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
              upscale_factor=2, fused_squeeze=True)


def _case_flax_checkpoint_served_by_the_port_matches_vsr_tpu(tmp_path):
    """A JAX trainer's checkpoint of a tiny DRFNet (numpy-drawn params, an
    optax Adam state, aux), served by the port's infer CLI and by
    ``vsr_tpu``'s pipeline from the same file."""
    side, d, t = 48, 2, 3
    jnet = JaxDRFNet(**DRF_KW)
    rng = np.random.default_rng(3)
    variables = randomize(init(jnet, np.zeros((1, 2, side // 2, side // 2, 1),
                                              np.float32)), rng)
    state = {"params": variables, "opt_state": optax.adam(1e-4).init(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))}
    ckpt = tmp_path / "model_best.ckpt"
    jax_save_checkpoint(ckpt, state, {"epoch": 5})

    vol = rng.integers(0, 1200, (side, side, d, t)).astype(np.int16)
    nifti.save_nifti(vol, tmp_path / "raw" / "p" / "p_4d.nii.gz")
    infer.main([str(tmp_path / "raw"), str(tmp_path / "sr"), "--video",
                "--device", "cpu", "--net", "DRFNet", "--net-kwargs",
                json.dumps(DRF_KW), "--checkpoint", str(ckpt)])
    got = nifti.load_nifti(tmp_path / "sr" / "p" / "p_4d_sr.nii.gz")

    net, params, _ = jinfer.build_serving_net(
        "DRFNet", DRF_KW, str(ckpt), lr_hw=(side // 2, side // 2), video=True)
    frames, _ = infer.load_hr_frames(tmp_path / "raw" / "p" / "p_4d.nii.gz")
    _, want = jinfer.make_pipeline(net, params, 2, "acdc", video_t=t)(
        frames.astype(np.float32))
    want = np.moveaxis(np.asarray(want), 0, -1).reshape(side, side, d, t)
    diff = np.abs(got.astype(np.float64) - want)
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1.0
    assert want.std() > 1.0
    # The seeded net serves something else: the weights came from the file.
    seeded = infer.build_serving_net("DRFNet", DRF_KW, device="cpu")
    with_ckpt = infer.build_serving_net("DRFNet", DRF_KW, str(ckpt),
                                        device="cpu")
    assert not torch.equal(seeded.in_block.convs[0].weight,
                           with_ckpt.in_block.convs[0].weight)
    with pytest.raises(ValueError, match="ema"):
        infer.build_serving_net("DRFNet", DRF_KW, str(ckpt), device="cpu",
                                ema=True)


# The cases run inside two tests, every case run and each failure named
# (see tests/test_torch_serve.py for why).


def test_reader_against_flax(tmp_path, monkeypatch):
    cases = [("_case_decoder_reads_every_type_flax_writes",
              lambda: _case_decoder_reads_every_type_flax_writes(monkeypatch))]
    cases += [(c.__name__, lambda c=c: c(subdir(tmp_path, c.__name__)))
              for c in (_case_sharded_files_read_and_foreign_files_refused,
                        _case_resuming_training_from_a_flax_checkpoint_is_refused)]
    cases.append(("_case_jax_trainer_checkpoint_reads_bit_equal",
                  lambda: _case_jax_trainer_checkpoint_reads_bit_equal(
                      subdir(tmp_path, "trainer"), monkeypatch)))
    run_cases(cases)


def test_flax_checkpoint_served_by_the_port(tmp_path):
    _case_flax_checkpoint_served_by_the_port_matches_vsr_tpu(tmp_path)
