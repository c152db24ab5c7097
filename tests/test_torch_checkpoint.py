"""The port's flax-checkpoint reader, weight bridge and config against
flax / ladder_tpu: the same trees, exact round trips, the same configs."""

import glob
import os
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from flax import serialization

from ladder_tpu.utils import config as jconfig
from ladder_tpu_torch.utils import checkpoint as tck
from ladder_tpu_torch.utils import config as tconfig
from ladder_tpu_torch.utils.weights import flax_to_torch, torch_to_flax

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINTS = [f"{fam}/{group}-model.msgpack"
               for fam in ("mnist_digit", "mnist_fashion", "celeba")
               for group in ("vae", "prior")]


def _assert_same_tree(a, b, path=""):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_reader_matches_flax_on_pretrained(name):
    data = (ROOT / "pretrained_models" / name).read_bytes()
    _assert_same_tree(tck.msgpack_restore(data),
                      serialization.msgpack_restore(data))


def test_reader_covers_the_msgpack_types():
    tree = {"i": [0, 1, 127, 128, 255, 65535, 2**32, -1, -32, -33, -200,
                  -40000, -2**40],
            "f": 1.5, "s": "x" * 40, "long": "y" * 70000, "b": b"\x00\x01",
            "t": True, "n": None, "nested": {str(k): k for k in range(20)},
            "arr": np.arange(6, dtype=np.int32).reshape(2, 3),
            "scalar": np.float32(2.5), "c": 1 + 2j,
            "big": np.zeros((70000,), np.float16)}
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(tck.msgpack_restore(data),
                      serialization.msgpack_restore(data))
    assert tck.msgpack_restore(msgpack.packb(0.25, use_single_float=True)) \
        == 0.25


@pytest.mark.parametrize("data", [b"\x92\x01", b"\x01\x02", b"\xc1"])
def test_reader_rejects_malformed(data):
    with pytest.raises(ValueError):
        tck.msgpack_restore(data)


def test_bridge_round_trips_pretrained_celeba_exactly():
    ck = ROOT / "pretrained_models" / "celeba"
    tree = {**tck.load_msgpack(ck / "vae-model.msgpack"),
            **tck.load_msgpack(ck / "prior-model.msgpack")}
    state = flax_to_torch(tree)
    assert state["encoder.Conv_0.weight"].shape == (128, 3, 3, 3)
    assert state["decoder.Dense_0.weight"].shape == (512, 256)
    assert state["encoder.code_mean.weight"].shape == (256, 2048)
    back = torch_to_flax({k: torch.tensor(v) for k, v in state.items()})
    _assert_same_tree(dict(sorted(back.items())), dict(sorted(tree.items())))


def test_bridge_permutes_flattened_rows_to_nchw():
    """code_mean row (h*2 + w)*C + c (NHWC flatten) becomes column
    c*4 + h*2 + w (NCHW flatten)."""
    c = 3
    k = np.arange(4 * c * 2, dtype=np.float32).reshape(4 * c, 2)
    tree = {"encoder": {"Conv_5": {"kernel": np.zeros((3, 3, c, c),
                                                      np.float32)},
                        "code_mean": {"kernel": k}}}
    w = flax_to_torch(tree)["encoder.code_mean.weight"]
    for h in range(2):
        for w_ in range(2):
            for ch in range(c):
                np.testing.assert_array_equal(
                    w[:, ch * 4 + h * 2 + w_], k[(h * 2 + w_) * c + ch])


def test_checkpoint_manager_merges_groups(tmp_path):
    tree = {"encoder": {"a": {"kernel": np.ones((2, 3), np.float32)}},
            "sigma": {"sigma": np.asarray(0.3, np.float32)},
            "prior": {"p": {"bias": np.zeros(4, np.float32)}}}
    cfg = {"checkpoint_dir": str(tmp_path)}
    mgr = tck.CheckpointManager(cfg)
    with open(mgr.path_vae, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {k: tree[k] for k in ("encoder", "sigma")}))
    template = {"encoder": {"a": {"kernel": np.zeros((2, 3), np.float32)}},
                "sigma": {"sigma": np.asarray(0.5, np.float32)},
                "prior": {"p": {"bias": np.ones(4, np.float32)}}}
    merged = mgr.load(mgr.load(template, "VAE"), "prior")  # no prior file
    _assert_same_tree(merged, {**template, "encoder": tree["encoder"],
                               "sigma": tree["sigma"]})
    bad = {**template, "encoder": {"a": {"kernel": np.zeros((3, 3))}}}
    with pytest.raises(ValueError, match="shape"):
        mgr.load(bad, "VAE")


@pytest.mark.parametrize("path", sorted(
    glob.glob(str(ROOT / "codes" / "*.json"))
    + glob.glob(str(ROOT / "demo" / "*.json"))), ids=os.path.basename)
def test_config_matches_ladder_tpu(path):
    assert tconfig.process_config(path) == jconfig.process_config(path)


def test_config_validation_messages():
    base = tconfig.apply_defaults({
        "exp_name": "celeba", "prior": "ours", "batch_size": 4,
        "code_size": 8, "num_hidden_units": 16, "load_dir": "default"})
    for bad in ({"prior": "nope"}, {"exp_name": "x"},
                {"num_hidden_units": 18}, {"dtype": "float16"},
                {"fused_train_step": 3}):
        cfg = {**base, **bad}
        with pytest.raises(ValueError) as want:
            jconfig.validate_config(dict(cfg))
        with pytest.raises(ValueError) as got:
            tconfig.validate_config(dict(cfg))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="missing required keys"):
        tconfig.validate_config({"prior": "ours"})
