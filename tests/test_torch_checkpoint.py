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
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

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


# ---- the asynchronous writer ------------------------------------------

def _groups_and_state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"encoder": {"a": {"kernel": rng.random((3, 4), np.float32)}},
              "decoder": {"b": {"bias": rng.random(5, np.float32)}},
              "sigma": {"sigma": np.asarray(0.3, np.float32)},
              "prior": {"p": {"bias": rng.random(4, np.float32)}},
              "inner_sigma": {"inner_sigma": np.asarray(0.1, np.float32)}}
    extra = {"cur_epoch": np.asarray(2), "metrics": {
        "train_loss": rng.random(7)}}
    return params, extra


def _manager(root, async_checkpoint):
    os.makedirs(root, exist_ok=True)
    return tck.CheckpointManager({"checkpoint_dir": str(root),
                                  "prior": "ours", "TRAIN_VAE": 1,
                                  "TRAIN_prior": 1,
                                  "async_checkpoint": async_checkpoint})


def _save_all(mgr, params, extra):
    mgr.save(params, model="joint")
    mgr.save_full({"params": params, "step": np.asarray(3, np.int32)}, extra)


def test_async_writer_writes_the_synchronous_bytes(tmp_path, capsys):
    params, extra = _groups_and_state()
    sync, asyn = (_manager(tmp_path / name, flag)
                  for name, flag in (("sync", 0), ("async", 1)))
    _save_all(sync, params, extra)
    _save_all(asyn, params, extra)
    # the caller's arrays change right after the save returns, as the
    # parameters do under the next in-place Adam update
    params["encoder"]["a"]["kernel"] += 1.0
    asyn.flush()
    for name in ("vae-model", "prior-model", "train-state"):
        got = (tmp_path / "async" / f"{name}.msgpack").read_bytes()
        assert got == (tmp_path / "sync" / f"{name}.msgpack").read_bytes()
    out = capsys.readouterr().out
    assert out.count("Outer VAE model saved.") == 2
    assert out.count("Prior model saved.") == 2


def test_snapshot_copies_tensors_and_arrays():
    t = torch.arange(4.0)
    a = np.arange(3.0)
    snap = tck._snapshot({"t": t, "a": [a, 5]})
    t += 1
    a += 1
    np.testing.assert_array_equal(snap["t"], np.arange(4.0))
    np.testing.assert_array_equal(snap["a"][0], np.arange(3.0))
    assert snap["a"][1] == 5 and isinstance(snap["t"], np.ndarray)


def test_async_writer_error_is_sticky_until_reset():
    writer = tck.AsyncCheckpointWriter()
    ran = []

    def fail():
        raise OSError("disk full")

    writer.submit(fail)
    with pytest.raises(RuntimeError, match="sticky") as err:
        writer.flush()
    assert isinstance(err.value.__cause__, OSError)
    with pytest.raises(RuntimeError):
        writer.submit(lambda: ran.append(1))
    with pytest.raises(RuntimeError):
        writer.flush()
    assert ran == []
    writer.reset_error()
    writer.submit(lambda: ran.append(1))
    writer.flush()
    assert ran == [1]


def test_async_read_after_write_sees_the_pending_save(tmp_path, monkeypatch):
    params, extra = _groups_and_state()
    mgr = _manager(tmp_path, 1)
    gate = __import__("threading").Event()
    real = tck.save_msgpack

    def slow_save(path, tree):
        gate.wait(10)
        real(path, tree)

    monkeypatch.setattr(tck, "save_msgpack", slow_save)
    _save_all(mgr, params, extra)
    assert not os.path.exists(mgr.path_state)   # still queued
    gate.set()
    template = {k: {kk: {kkk: np.zeros_like(vvv) for kkk, vvv in vv.items()}
                    if isinstance(vv, dict) else np.zeros_like(vv)
                    for kk, vv in v.items()} for k, v in params.items()}
    loaded = mgr.load(mgr.load(template, "VAE"), "prior")
    _assert_same_tree(loaded, params)
    state, got_extra = mgr.load_full()
    _assert_same_tree(state["params"], {k: params[k] for k in sorted(params)})
    assert int(got_extra["cur_epoch"]) == 2


def test_trainer_with_async_checkpoints_writes_the_same_files(tmp_path):
    """One tiny mnist_digit epoch with async_checkpoint 1 and with 0, the
    same seed: the same checkpoint files, byte for byte."""
    from ladder_tpu_torch.data.mnist import DataGenerator
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.trainer import MNISTTrainer
    from ladder_tpu_torch.utils.config import create_dirs
    from tests.conftest import make_config

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    files = {}
    try:
        for flag in (0, 1):
            cfg = make_config(num_epochs=1, sg_pretraining=0,
                              accurate_fit=1, synthetic_n_train=128,
                              synthetic_n_test=128, num_hidden_units=64,
                              num_hidden_units_inner_VAE=8,
                              n_layers_inner_VAE=2, n_MC_samples=2,
                              n_mixtures=3, enable_plots=0,
                              async_checkpoint=flag)
            cfg["result_dir"] = str(tmp_path / f"r{flag}") + "/"
            cfg["checkpoint_dir"] = str(tmp_path / f"c{flag}") + "/"
            create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
            trainer = MNISTTrainer(make_model(cfg, seed=1),
                                   DataGenerator(cfg), cfg, device="cpu")
            trainer.train()
            files[flag] = {p.name: p.read_bytes() for p in
                           Path(cfg["checkpoint_dir"]).glob("*.msgpack")}
    finally:
        torch.set_num_threads(before)
    assert sorted(files[1]) == sorted(files[0]) == [
        "prior-model.msgpack", "train-state.msgpack", "vae-model.msgpack"]
    for name in files[0]:
        assert files[1][name] == files[0][name], name
