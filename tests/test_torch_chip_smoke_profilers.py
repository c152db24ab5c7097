"""chip_smoke.py's profilers phase (13) off the card: its checks on
hand-made kernel rows and records, and the launches it expects of
profile_step's two runs and of stream_trace. The phase itself needs the
card: a CPU trace holds no kernel, and the profilers stop on it
(tests/test_torch_profilers.py)."""

import math

import pytest

import chip_smoke
from ladder_tpu_torch import profile_step, stream_trace
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

# kernel names as a trace shows them, with PyTorch's and our helpers'
# kernels beside them
NAMES = {
    "norm_chain_fwd": ("void norm_chain_fwd_ring<float>(float const*, "
                       "float const*)",
                       "void norm_chain_fwd_regs<__nv_bfloat16, 4, 16, 1>"
                       "(__nv_bfloat16 const*)"),
    "norm_chain_bwd": ("void norm_chain_bwd_kernel<float, 16>(float const*)",),
    "output_stage_fwd": ("void output_stage_fwd_kernel<float>(float const*)",),
    "output_stage_bwd": ("void output_stage_bwd_kernel<float, true>(float "
                         "const*)",),
    "adam_update": ("adam_kernel(GradTable, ParamTable, float)",)}
DECOYS = ("nonfinite_kernel(GradTable)", "sum_partials_kernel(float const*)",
          "sum_loss_partials_kernel(float const*)",
          "void at::native::vectorized_elementwise_kernel<4>(int)")
MODE2 = {"norm_chain_fwd": 4, "norm_chain_bwd": 4, "output_stage_fwd": 1,
         "output_stage_bwd": 1, "adam_update": 4}


def rows_for(per_step, steps):
    """Report rows of ``steps`` steps with ``per_step`` launches of each
    kernel, the first name of a kernel taking all but one of them."""
    rows = []
    for k, names in NAMES.items():
        n = per_step[k] * steps
        for i, name in enumerate(names):
            share = n - (len(names) - 1) if i == 0 else 1
            rows.append((name, 0.1, share / steps, share))
    rows += [(name, 0.5, 3.0, 3 * steps) for name in DECOYS]
    return rows


def test_trace_launches_name_the_five_kernels():
    assert chip_smoke.trace_launches(rows_for(MODE2, 8)) == {
        k: 8 * v for k, v in MODE2.items()}
    assert set(chip_smoke.KERNEL_TRACE_NAMES) == set(
        chip_smoke.kernel_counters())


def test_check_launches():
    counted = {k: 11 * v for k, v in MODE2.items()}
    in_trace = chip_smoke.check_launches("run", rows_for(MODE2, 8), counted,
                                         MODE2, 8, 11)
    assert in_trace == {k: 8 * v for k, v in MODE2.items()}
    short = [r for r in rows_for(MODE2, 8) if "adam_kernel" not in r[0]]
    with pytest.raises(AssertionError, match="0 adam_update kernels"):
        chip_smoke.check_launches("run", short, counted, MODE2, 8, 11)
    with pytest.raises(AssertionError, match="norm_chain_bwd counted 43"):
        chip_smoke.check_launches("run", rows_for(MODE2, 8),
                                  dict(counted, norm_chain_bwd=43), MODE2,
                                  8, 11)


def test_profile_runs_launch_every_kernel():
    """bf16 mode 2 (the default) and float32 mode 1: K1-K5 every step."""
    want = []
    for _, argv in chip_smoke.PROFILE_RUNS:
        args = profile_step.parse_args(list(argv))
        want.append(chip_smoke.expected_step_launches(
            profile_step.build_config(args), args.fused, "cuda"))
    assert want == [MODE2, dict(MODE2, norm_chain_fwd=16,
                                output_stage_fwd=4)]
    args = stream_trace.parse_args([])
    assert chip_smoke.expected_step_launches(
        stream_trace.build_config(args), 2, "cuda") == MODE2
    assert (args.steps, args.warmup) == (40, 6)


def test_check_conv_rows():
    row = ("enc1", "128x128", 3, 128, 1.0, 0.5, 2.0, 0.6, 1.7, 0.7, 1.4)
    chip_smoke.check_conv_rows("conv", [row] * 14)
    with pytest.raises(AssertionError, match="13 conv rows"):
        chip_smoke.check_conv_rows("conv", [row] * 13)
    bad = row[:7] + (math.nan,) + row[8:]
    with pytest.raises(AssertionError, match="enc1 timed"):
        chip_smoke.check_conv_rows("conv", [row] * 13 + [bad])


def test_check_stream_record():
    rec = dict.fromkeys(chip_smoke.STREAM_KEYS, 1.0)
    rec.update(wall_step_ms=90.0, device_busy_ms=80.0)
    chip_smoke.check_stream_record(rec)
    with pytest.raises(AssertionError, match="under its busy"):
        chip_smoke.check_stream_record(dict(rec, wall_step_ms=70.0))
    with pytest.raises(AssertionError, match="keys"):
        chip_smoke.check_stream_record(
            {k: v for k, v in rec.items() if k != "link_mbs"})
