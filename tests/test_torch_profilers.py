"""The port's profilers (python -m ladder_tpu_torch.{profile_step,
conv_breakdown,bench_input_pipeline,stream_trace}) against the JAX
package's scripts, loaded with importlib (never imported by the port):
the same configs, conv shapes and flop counts, the same input-pipeline
record; the trace readers on a hand-written Chrome trace; a capture on
the CPU writes its trace and then stops, since it holds no CUDA kernel."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ladder_tpu_torch import (bench_input_pipeline, conv_breakdown,
                              profile_step, stream_trace)
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def jax_config(monkeypatch, call):
    """The config the JAX script hands to ladder_tpu's make_model."""
    import ladder_tpu.models.builder as builder
    seen = []

    def record(cfg, *args, **kwargs):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(builder, "make_model", record)
    monkeypatch.setenv("LADDER_NO_COMPILE_CACHE", "1")
    with pytest.raises(_Stop):
        call()
    return seen[0]


@pytest.mark.parametrize("argv", [
    [], ["--batch", "8", "--hidden", "64", "--dtype", "float32", "--fused",
         "1", "--fused-output", "1"]])
def test_profile_step_config_is_the_jax_scripts(monkeypatch, argv):
    args = profile_step.parse_args(argv)
    want = jax_config(monkeypatch,
                      lambda: load_script("profile_step").capture(args))
    assert profile_step.build_config(args) == want


@pytest.mark.parametrize("argv", [[], ["--batch", "8", "--hidden", "64"]])
def test_stream_trace_config_is_the_jax_scripts(monkeypatch, argv):
    want = jax_config(monkeypatch,
                      lambda: load_script("stream_trace").main(argv))
    assert stream_trace.build_config(stream_trace.parse_args(argv)) == want


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": args}


def hand_trace(tmp_path):
    """Three marked steps of 100 us. Each: a norm-chain kernel [20, 30),
    a copy [35, 45) under a gemm [40, 70), an Adam kernel [75, 80) whose
    arguments carry bytes; a tail kernel [295, 310) after the last."""
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "python"}}]
    for s in range(3):
        base = 100 * s
        events += [
            _x(f"ladder_step#{s}", "user_annotation", base, 100),
            _x("aten::conv2d", "cpu_op", base + 5, 3),
            _x("void norm_chain_fwd_ring<float>(float const*)", "kernel",
               base + 20, 10),
            _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", base + 35,
               10),
            _x("sm90_xmma_gemm_f32f32", "kernel", base + 40, 30),
            _x("adam_kernel(GradTable)", "kernel", base + 75, 5,
               bytes=1e6)]
    events += [_x("ladder_step#1", "gpu_user_annotation", 100, 200),
               _x("tail_kernel", "kernel", 295, 15)]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path)


def test_report_sums_the_kernel_lane(tmp_path, capsys):
    logdir = hand_trace(tmp_path)
    args = profile_step.parse_args(["--report-only", "--steps", "3",
                                    "--logdir", logdir])
    rows = profile_step.report(args)
    assert [(name, n) for name, _, _, n in rows] == [
        ("sm90_xmma_gemm_f32f32", 3),
        ("void norm_chain_fwd_ring<float>(float const*)", 3),
        ("adam_kernel(GradTable)", 3), ("tail_kernel", 1)]
    assert [r[1] for r in rows] == pytest.approx([0.03, 0.01, 0.005, 0.005])
    assert [r[2] for r in rows] == pytest.approx([1, 1, 1, 1 / 3])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == ("total kernel time 0.05 ms/step over 3 steps; top 40 "
                      "kernels:")
    assert out[2].split() == ["ms/step", "x", "GB/s", "TF/s", "op"]
    # no bytes or flops: '-'; the Adam kernel's bytes give 1e6 B / 5 us
    assert out[3].split()[:4] == ["0.030", "1", "-", "-"]
    assert out[5].split()[:4] == ["0.005", "1", "200", "-"]
    assert out[6].split()[:4] == ["0.005", "0", "-", "-"]


def test_stream_window_and_busy(tmp_path):
    """Steps 1-2: the window [100, 310) us; busy a step the norm chain 10,
    the copy and the gemm's union 35, Adam 5; the tail 15: 115 us; the
    device-side step span is not device work."""
    window, busy, steps = stream_trace.device_window_and_busy(
        hand_trace(tmp_path))
    assert (window, busy, steps) == (pytest.approx(0.21),
                                     pytest.approx(0.115), 2)


def test_cpu_captures_write_a_trace_and_stop(tmp_path):
    small = ["--device", "cpu", "--hidden", "16", "--batch", "2",
             "--steps", "2"]
    args = profile_step.parse_args(small + ["--dtype", "float32",
                                            "--logdir", str(tmp_path / "p")])
    # the step after the first, on the host alone
    summary = profile_step.capture(args)
    assert summary["steps"] == 1 and summary["wall_ms"] > 0
    assert summary["device_busy_ms"] == summary["copy_ms"] == 0
    assert json.loads((tmp_path / "p" / "summary.json").read_text()) == \
        summary
    with pytest.raises(SystemExit, match="no CUDA kernel"):
        profile_step.report(args)
    with pytest.raises(SystemExit, match="no CUDA activity"):
        stream_trace.main(small + ["--warmup", "1", "--logdir",
                                   str(tmp_path / "s"), "--out",
                                   str(tmp_path / "s.json")])
    assert (tmp_path / "s" / "trace.json").is_file()


@pytest.mark.parametrize("module, argv", [
    (profile_step, []), (stream_trace, []), (conv_breakdown, []),
    (bench_input_pipeline, ["--records", "unused"])],
    ids=["profile_step", "stream_trace", "conv_breakdown",
         "bench_input_pipeline"])
def test_the_card_by_default(module, argv):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_conv_rows_are_the_jax_scripts(monkeypatch, capsys):
    """The table's name, hw, cin, cout and GF at batch 2, h=16; nothing
    is timed (both timeits stubbed)."""
    jmod = load_script("conv_breakdown")
    monkeypatch.setattr(jmod, "timeit", lambda fn, *a, **k: 1e-3)
    monkeypatch.setattr(conv_breakdown, "timeit", lambda fn, *a, **k: 1e-3)
    monkeypatch.setattr(sys, "argv", ["conv_breakdown.py", "--batch", "2",
                                      "--hidden", "16", "--dtype", "float32"])
    jmod.main()
    lines = capsys.readouterr().out.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("layer"))
    want = [(ln[:16].strip(), *ln[16:].split()[:4])
            for ln in lines[head + 1:head + 15]]
    rows = conv_breakdown.main(["--batch", "2", "--hidden", "16",
                                "--dtype", "float32", "--device", "cpu"])
    assert [(r[0], r[1], str(r[2]), str(r[3]), f"{r[4]:.2f}")
            for r in rows] == want
    assert len(rows) == 14


@pytest.mark.parametrize("shape", conv_breakdown.conv_shapes(16),
                         ids=lambda s: s[0].replace(" ", "_"))
def test_conv_matches_jax_vjp(shape):
    """Forward, input-grad and weight-grad of each shape against jax.vjp
    of the JAX script's conv (NHWC / HWIO), float32, batch 2, h=16, within
    1e-5 of each output's largest magnitude."""
    name, hw, cin, cout, k, stride, pad = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride, stride), pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    y, vjp = jax.vjp(conv, x, w)
    cot = rng.standard_normal(y.shape).astype(np.float32)
    dx, dw = vjp(cot)
    fwd, dgrad, wgrad = conv_breakdown.conv_fns(hw, k, stride, pad)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1)
    tc = torch.from_numpy(cot).permute(0, 3, 1, 2)
    for got, want in ((fwd(tx, tw).permute(0, 2, 3, 1), y),
                      (dgrad(tx, tw, tc).permute(0, 2, 3, 1), dx),
                      (wgrad(tx, tw, tc).permute(2, 3, 1, 0), dw)):
        want = np.asarray(want)
        assert got.shape == want.shape
        # float32 sums of up to 32,768 products in two orders: within 1e-5
        # of the largest magnitude
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_input_pipeline_record_is_the_jax_scripts(tmp_path, monkeypatch,
                                                   capsys):
    """tests/test_scripts.py's records (128 images, size 32, batch 16)
    through both scripts."""
    from ladder_tpu.data.celeba import ensure_synthetic_tfrecords

    ensure_synthetic_tfrecords(str(tmp_path), n_train=128, n_val=1,
                               n_test=1, size=32)
    common = ["--records", str(tmp_path / "celebA_train.tfrecords"),
              "--size", "32", "--batch", "16", "--repeats", "1"]
    jmod = load_script("bench_input_pipeline")

    def jax_record():
        monkeypatch.setattr(sys, "argv", ["bench_input_pipeline.py"] + common)
        jmod.main()
        return json.loads([ln for ln in capsys.readouterr().out.splitlines()
                           if ln.startswith("{")][-1])

    want = jax_record()
    rec = bench_input_pipeline.main(common + ["--device", "cpu"])
    assert list(rec) == [k for k in want if k != "native_error"] or (
        "native_error" in want
        and set(rec) == set(want) - {"native_error"} | {"native"})
    for key in ("n_images", "batch", "image_shape"):
        assert rec[key] == want[key]
    for backend in ("python", "native"):
        assert min(rec[backend].values()) > 0
    assert rec["device_ceiling_img_s"] is None
    assert rec["required_transfer_mb_s"] is None
    assert rec["host_headroom_x"] is None

    monkeypatch.setattr(jmod, "HEADLINE_STEP_MS", 40.0)
    want = jax_record()
    capsys.readouterr()
    rec = bench_input_pipeline.main(common + ["--device", "cpu",
                                              "--step-ms", "40"])
    for key in ("device_ceiling_img_s", "required_transfer_mb_s"):
        assert rec[key] == want[key]
    # 16 images a step of 40 ms x 16 / 64
    assert rec["device_ceiling_img_s"] == 1600.0
    assert rec["host_headroom_x"] == round(rec["native"]["img_s"] / 1600, 2)
