"""``python -m vsr_tpu_torch.convert --consolidate`` and the port's reader of
``vsr_tpu``'s sharded-v1 checkpoints, against ``vsr_tpu``.

``vsr_tpu.utils.checkpoint.save_checkpoint_sharded`` writes an EDSRNet's
variables and Adam state sharded over the 8 host devices of
``tests/conftest.py`` (as ``tests/test_sharded_ckpt.py`` does), once as
process 0 and once as process 1 of a two-process save (one main file, two
shard files). Held: the port's consolidation is byte-equal to JAX's (with
chunked arrays and a bfloat16 leaf), ``load_flax_checkpoint`` and ``infer
--checkpoint`` take the sharded main file directly, and a missing shard, a
shard of another save and a file that is not sharded-v1 are refused; the
port's writer of that layout (``save_flax_checkpoint_sharded``, which
``chip_smoke.py`` serves on the card) writes JAX's bytes. The
port's own sharded checkpoints are held in ``tests/test_torch_parallel.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests._torch_cases import run_cases, subdir
from tests._torch_parity import init, randomize
from vsr_tpu.models import EDSRNet as JaxEDSRNet
from vsr_tpu.utils import checkpoint as jax_checkpoint
from vsr_tpu_torch import convert, infer
from vsr_tpu_torch.io import nifti
from vsr_tpu_torch.utils import checkpoint, msgpack

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices")

EDSR_KW = dict(in_channels=1, out_channels=1, num_resblocks=1,
               num_features=8, upscale_factor=2)


def _sharded_state():
    """An EDSRNet's variables and Adam state, every kernel sharded over
    its output features on 8 devices, with a bfloat16 leaf."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    variables = randomize(init(JaxEDSRNet(**EDSR_KW),
                               np.zeros((1, 8, 8, 1), np.float32)),
                          np.random.default_rng(0))

    def place(leaf):
        spec = (P(*([None] * (leaf.ndim - 1)), "data")
                if leaf.ndim == 4 and leaf.shape[-1] % 8 == 0 else P())
        return jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, spec))

    params = jax.tree_util.tree_map(place, variables)
    opt_state = jax.tree_util.tree_map(
        lambda x: place(np.asarray(x)) if np.ndim(x) else x,
        optax.adam(1e-3).init(params["params"]))
    params["params"]["head_bf16"] = jax.device_put(
        jnp.linspace(-2, 2, 16, dtype=jnp.bfloat16).reshape(2, 8),
        NamedSharding(mesh, P(None, "data")))
    return {"params": params, "opt_state": opt_state}


def _save_two_processes(monkeypatch, path, state, aux):
    """``save_checkpoint_sharded`` as process 0 and 1 of a 2-process save."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for proc in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda p=proc: p)
        jax_checkpoint.save_checkpoint_sharded(path, state, aux)
    monkeypatch.undo()


def _case_consolidation_is_byte_equal(tmp_path, monkeypatch):
    import flax.serialization as flax_serialization

    # Small chunks: both writers split the arrays alike.
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    main = tmp_path / "model_2.ckpt"
    aux = {"epoch": 2, "monitor": {"best": 0.5, "best_sign": 1,
                                   "not_improved_count": 0},
           "lr_scheduler": None, "random_seed": "vsr"}
    state = _sharded_state()
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for proc in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda p=proc: p)
        jax_checkpoint.save_checkpoint_sharded(main, state, aux)
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model_2.ckpt", "model_2.ckpt.shard0", "model_2.ckpt.shard1"]
    jax_checkpoint.consolidate_sharded_checkpoint(main, tmp_path / "jax.ckpt")
    convert.main(["--consolidate", str(main), str(tmp_path / "port.ckpt")])
    want = (tmp_path / "jax.ckpt").read_bytes()
    assert b"__msgpack_chunked_array__" in want
    assert (tmp_path / "port.ckpt").read_bytes() == want
    # The main file read directly equals JAX's consolidation.
    got_state, got_aux = checkpoint.load_flax_checkpoint(main)
    want_payload = serialization.msgpack_restore(want)
    assert got_aux == want_payload["aux"] == aux
    assert _same_tree(want_payload["state"], got_state) > 10


def _same_tree(want, got, path="") -> int:
    """Leaf for leaf, bit for bit (a bfloat16 leaf, a ``torch.bfloat16``
    tensor in the port, by its 16-bit patterns); returns the leaf count."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), path
        return sum(_same_tree(want[k], got[k], f"{path}/{k}") for k in want)
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    np.testing.assert_array_equal(got, want, err_msg=path)
    assert got.dtype == want.dtype, path
    return 1


def _case_infer_serves_the_sharded_main_file(tmp_path, monkeypatch):
    main = tmp_path / "model_1.ckpt"
    state = _sharded_state()
    del state["params"]["params"]["head_bf16"]
    _save_two_processes(monkeypatch, main, state, {"epoch": 1})
    jax_checkpoint.consolidate_sharded_checkpoint(main, tmp_path / "one.ckpt")
    vol = np.random.default_rng(1).integers(0, 1200, (16, 16, 1, 2))
    nifti.save_nifti(vol.astype(np.int16),
                     tmp_path / "raw" / "patientA" / "patientA_4d.nii.gz")
    outs = {}
    for name in ("model_1.ckpt", "one.ckpt"):
        out = tmp_path / f"out_{name}"
        infer.main([str(tmp_path / "raw"), str(out), "--device", "cpu",
                    "--net", "EDSRNet", "--net-kwargs", json.dumps(EDSR_KW),
                    "--checkpoint", str(tmp_path / name)])
        (path,) = out.rglob("*.nii.gz")
        outs[name] = nifti.load_nifti(path)[0]
    np.testing.assert_array_equal(outs["model_1.ckpt"], outs["one.ckpt"])


def _case_the_ports_writer_of_the_jax_layout(tmp_path, monkeypatch):
    """``checkpoint.save_flax_checkpoint_sharded`` writes the bytes of
    ``vsr_tpu``'s ``save_checkpoint_sharded`` (one process, 8 devices)."""
    state = _sharded_state()
    aux = {"epoch": 3, "random_seed": "vsr"}
    jax_checkpoint.save_checkpoint_sharded(tmp_path / "jax.ckpt", state, aux)
    blocks, port_state = {}, {}

    def to_port(path, leaf):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        if isinstance(leaf, jax.Array) and not leaf.is_fully_replicated:
            blocks[key] = 8
        value = np.array(leaf)
        if value.dtype.name == "bfloat16":
            return torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
        return value

    # The state dict flax writes (optax's tuples as "0", "1", ... dicts).
    port_state = jax.tree_util.tree_map_with_path(
        to_port, serialization.to_state_dict(state))
    assert len(blocks) > 4
    checkpoint.save_flax_checkpoint_sharded(tmp_path / "port.ckpt",
                                            port_state, aux, blocks)
    for suffix in ("", ".shard0"):
        assert ((tmp_path / f"port.ckpt{suffix}").read_bytes()
                == (tmp_path / f"jax.ckpt{suffix}").read_bytes()), suffix


def _case_refusals(tmp_path, monkeypatch):
    main, other = tmp_path / "m.ckpt", tmp_path / "o.ckpt"
    state = _sharded_state()
    _save_two_processes(monkeypatch, main, state, {"epoch": 1})
    _save_two_processes(monkeypatch, other, state, {"epoch": 2})
    (tmp_path / "m.ckpt.shard1").write_bytes(
        (tmp_path / "o.ckpt.shard1").read_bytes())
    for fn in (lambda: checkpoint.load_flax_checkpoint(main),
               lambda: convert.main(["--consolidate", str(main),
                                     str(tmp_path / "x.ckpt")])):
        with pytest.raises(ValueError, match="is from a different save"):
            fn()
    (tmp_path / "m.ckpt.shard1").unlink()
    with pytest.raises(FileNotFoundError, match="missing .*m.ckpt.shard1"):
        checkpoint.load_flax_checkpoint(main)
    plain = tmp_path / "plain.ckpt"
    jax_checkpoint.save_checkpoint(plain, {"params": {"a": np.zeros(2)}}, {})
    with pytest.raises(ValueError, match="is not a sharded-v1 checkpoint"):
        convert.main(["--consolidate", str(plain), str(tmp_path / "y.ckpt")])
    for arg in ("--config", "--torch-ckpt", "--import-opt"):
        with pytest.raises(NotImplementedError, match=f"convert {arg}"):
            convert.main([arg, "x", "--consolidate", "a", "b"])
    assert not (tmp_path / "x.ckpt").exists()


def test_consolidate_and_serve_jax_sharded_checkpoints(tmp_path, monkeypatch):
    def patched(case, name):
        def thunk():
            with monkeypatch.context() as m:
                case(subdir(tmp_path, name), m)
        return thunk

    run_cases([
        ("consolidation byte-equal, main file read directly",
         patched(_case_consolidation_is_byte_equal, "bytes")),
        ("infer --checkpoint on the main file",
         patched(_case_infer_serves_the_sharded_main_file, "infer")),
        ("the port's writer of the JAX layout",
         patched(_case_the_ports_writer_of_the_jax_layout, "writer")),
        ("missing and mixed shards, other files, other arguments",
         patched(_case_refusals, "refusals")),
    ])
