"""The benchmark's own arithmetic: the card's peaks, the operations of a
CelebA-128 LaDDer step and serving call counted from the configuration's
shapes, the bytes each of the program's five kernels must move, the
kernels' names in a trace, the reading of a profiler trace, and the
percentile. Nothing here imports the measured program; later changes to
the program leave this yardstick as it is.
"""

from __future__ import annotations

import json
import math
import os
import re

# NVIDIA H100 SXM, dense rates (the data sheet; 700 W)
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12

# the five kernels' names in a trace (csrc/*.cu); one launch a call
KERNEL_PATTERNS = {
    "norm_chain_fwd": r"\bnorm_chain_fwd_(kernel|regs|ring)\b",
    "norm_chain_bwd": r"\bnorm_chain_bwd_kernel\b",
    "output_stage_fwd": r"\boutput_stage_fwd_kernel\b",
    "output_stage_bwd": r"\boutput_stage_bwd_kernel\b",
    "adam_update": r"\badam_kernel\b",
}
_KERNEL_RES = {k: re.compile(p) for k, p in KERNEL_PATTERNS.items()}

# the Chrome trace's device activity (the device-side copies of the host's
# profiler ranges, "gpu_user_annotation", are left out)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "portbench_traced_window"


def itemsize(dtype):
    return 2 if dtype == "bfloat16" else 4


# ---- operations -------------------------------------------------------

def conv_layers(cfg):
    """(name, in size, Cin, Cout, k, out size) of every convolution of the
    model, encoder first (the GF column of the port's conv_breakdown)."""
    h = cfg["num_hidden_units"]
    k = cfg["kernel_size"]
    enc, size, cin = [], cfg["dim_input_x"], cfg["dim_input_channel"]
    for i, w in enumerate([h // 4, h // 4, h // 2, h // 2, h]):
        out = -(-size // 2)
        enc.append((f"enc{i + 1}", size, cin, w, k, out))
        size, cin = out, w
    enc.append(("enc6 valid", size, h, h, k, size - k + 1))
    dec = [("dec 1x1 in", 1, h, h, 1, 1),
           ("dec 2x2 a", 2, h, h, 3, 2), ("dec 2x2 b", 2, h, h, 3, 2),
           ("dec 8x8", 8, h, h, 3, 8), ("dec 16x16", 16, h, h // 2, 3, 16),
           ("dec 32x32", 32, h // 2, h // 2, 3, 32),
           ("dec 64x64", 64, h // 2, h // 4, 3, 64),
           ("dec 128x128", 128, h // 4, h // 4, 3, 128),
           ("dec 1x1 out", 128, h // 4, 3, 1, 128)]
    return enc, dec


def conv_flops(batch, layer):
    _, _, cin, cout, k, out = layer
    return 2.0 * batch * out * out * cout * k * k * cin


def dense_layers(cfg):
    """(in, out) of the dense layers: encoder heads, decoder MLP and style
    projections, inner encoder, inner decoder."""
    h, code = cfg["num_hidden_units"], cfg["code_size"]
    hi, rep, nl = (cfg["num_hidden_units_inner_VAE"],
                   cfg["representation_size"], cfg["n_layers_inner_VAE"])
    flat = h * 4
    enc = [(flat, code), (flat, code)]
    dec = [(code, h)] + [(h, h)] * 8 + [(h, 2 * c) for c in
                                        (h, h, h // 2, h // 4)]
    inner_enc = [(code, hi)] + [(hi, hi)] * (nl - 1) + [(hi, rep)] * 2
    inner_dec = [(rep, hi)] + [(hi, hi)] * (nl - 1) + [(hi, code)]
    return enc, dec, inner_enc, inner_dec


def forward_flops(cfg, batch):
    """Multiply-adds x 2 of one forward over ``batch`` rows, by part:
    {'enc', 'dec', 'inner_enc', 'inner_dec'}. The bilinear resizes count
    two taps an axis (what the mathematics needs); elementwise work and
    the mixture's triangular solves are left out (under 0.1%)."""
    enc_c, dec_c = conv_layers(cfg)
    enc_d, dec_d, ie_d, id_d = dense_layers(cfg)
    h = cfg["num_hidden_units"]

    def dense(layers):
        return sum(2.0 * batch * i * o for i, o in layers)

    resize = 0.0
    for c, out in ((h, 2), (h, 8), (h, 16), (h // 2, 32), (h // 2, 64),
                   (h // 4, 128)):
        resize += 2 * 2 * 2.0 * batch * c * out * out
    return dict(
        enc=sum(conv_flops(batch, l) for l in enc_c) + dense(enc_d),
        dec=sum(conv_flops(batch, l) for l in dec_c) + dense(dec_d) + resize,
        inner_enc=dense(ie_d), inner_dec=dense(id_d))


def _first_conv_flops(cfg, batch):
    return conv_flops(batch, conv_layers(cfg)[0][0])


def train_step_flops(cfg, batch, mode):
    """The operations a train step's mathematics needs.

    Mode 2: one forward and its backward (the gradient to every weight and
    to every activation but the images: twice the forward, less the first
    convolution's input gradient). Mode 1: the ae group's forward and
    backward (weights of encoder and decoder, activations through the
    inner VAE too); the sigma group's full forward at the updated weights;
    for the prior and inner_sigma groups the encoder and inner-VAE forward
    and the inner VAE's backward. No decoder is counted there."""
    f = forward_flops(cfg, batch)
    full = sum(f.values())
    first = _first_conv_flops(cfg, batch)
    inner = f["inner_enc"] + f["inner_dec"]
    if mode == 2:
        return 3 * full - first
    ae = full + 2 * (f["enc"] + f["dec"]) - first + inner
    sigma = full
    prior = f["enc"] + inner + 2 * inner
    return ae + sigma + 2 * prior


def serve_row_flops(cfg, path):
    """The operations of one served row of ``path``."""
    f = forward_flops(cfg, 1)
    if path == "reconstruct":
        return f["enc"] + f["dec"]
    if path == "represent":
        return f["enc"] + f["inner_enc"]
    raise ValueError(path)


# ---- the kernels' bytes ------------------------------------------------

def style_stages(cfg):
    """(channels, H*W) of the four instance-norm stages of a decode."""
    h = cfg["num_hidden_units"]
    return [(h, 4), (h, 4), (h // 2, 256), (h // 4, 4096)]


def kernel_bounds(cfg, batch, dtype):
    """Per call of each kernel at ``batch`` rows: (bytes, flops), each
    input byte read once and each output byte written once.
    norm_chain_*: the four launches of one decode together."""
    a = itemsize(dtype)
    out_hw = cfg["dim_input_x"] * cfg["dim_input_y"]
    c = cfg["num_hidden_units"] // 4
    n_fwd = n_bwd = 0.0
    for ch, hw in style_stages(cfg):
        planes = batch * ch
        n_fwd += 2 * planes * hw * a + 2 * planes * a
        n_bwd += 3 * planes * hw * a + 2 * planes * a + 2 * planes * 4
    u = batch * c * out_hw * a
    img = batch * 3 * out_hw * 4
    out_fwd = (u + img + img + 3 * c * 4 + 12, 2.0 * batch * out_hw * 3 * c)
    out_bwd = (2 * u + 2 * img + 3 * c * 4 + (3 * c + 3) * 4,
               4.0 * batch * out_hw * 3 * c)
    return {"norm_chain_fwd": (n_fwd, 0.0), "norm_chain_bwd": (n_bwd, 0.0),
            "output_stage_fwd": out_fwd, "output_stage_bwd": out_bwd}


def adam_bytes(n_elements):
    """Read g, p, m, v and write p, m, v: 28 bytes an element."""
    return 28.0 * n_elements


def bound_seconds(n_bytes, flops, dtype):
    return max(n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


def train_step_kernels(cfg, batch, dtype, mode, group_sizes):
    """{kernel: (launches a step, bound seconds a step)} of a train step;
    group_sizes: elements of each optimiser group (one Adam launch each)."""
    b = kernel_bounds(cfg, batch, dtype)
    decodes = 4 if mode == 1 else 1

    def sec(name, n):
        return n * bound_seconds(*b[name], dtype)

    adam = sum(bound_seconds(adam_bytes(n), 0.0, "float32")
               for n in group_sizes)
    return {"norm_chain_fwd": (4 * decodes, sec("norm_chain_fwd", decodes)),
            "norm_chain_bwd": (4, sec("norm_chain_bwd", 1)),
            "output_stage_fwd": (decodes, sec("output_stage_fwd", decodes)),
            "output_stage_bwd": (1, sec("output_stage_bwd", 1)),
            "adam_update": (len(group_sizes), adam)}


# ---- the trace --------------------------------------------------------

def profiler(device):
    """torch.profiler over the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def read_profile(prof, workdir):
    """The summary of a finished profile, through its Chrome trace (written
    to ``workdir`` and removed)."""
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    summary = summarise(read_trace(path))
    os.remove(path)
    return summary


def read_trace(path):
    """A Chrome trace written by torch.profiler -> its complete events
    (name, category, start us, end us, is device)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") == "gpu_user_annotation":
            continue
        start = float(e["ts"])
        out.append((e["name"], e.get("cat", ""), start,
                    start + float(e.get("dur", 0)),
                    e.get("cat") in DEVICE_CATEGORIES))
    return out


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarise(events):
    """The traced window (the benchmark's mark, extended to the last device
    activity that began in it): window and busy seconds, the idle share,
    kernel seconds and launches by name, the top device operations and the
    longest idle gaps labelled by the host operation running then."""
    marks = [(a, b) for name, _, a, b, dev in events
             if not dev and name == WINDOW_MARK]
    if not marks:
        return None
    lo, hi = marks[0]
    device = [(name, max(a, lo), b) for name, _, a, b, dev in events
              if dev and a >= lo and a < hi]
    if not device:
        return None
    hi = max(hi, max(b for _, _, b in device))
    busy = _union([(a, b) for _, a, b in device])
    by_name = {}
    for name, a, b in device:
        s = by_name.setdefault(name, [0, 0.0])
        s[0] += 1
        s[1] += (b - a) / 1e6
    kernels = {}
    for k, rx in _KERNEL_RES.items():
        n, sec = 0, 0.0
        for name, (count, s) in by_name.items():
            if rx.search(name):
                n += count
                sec += s
        kernels[k] = (n, sec)
    # idle gaps between device activity, labelled by the innermost host
    # operation that covers the gap's start (a sweep: few are open at once)
    host = sorted((a, b, name) for name, cat, a, b, dev in events
                  if not dev and cat in ("cpu_op", "python_function",
                                         "user_annotation")
                  and b > lo and a < hi and name != WINDOW_MARK)
    gaps, end = [], lo
    for _, a, b in sorted(device, key=lambda d: d[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    labels, open_ops, nxt = {}, [], 0
    for g0, g1 in gaps:
        while nxt < len(host) and host[nxt][0] <= g0:
            open_ops.append(host[nxt])
            nxt += 1
        open_ops = [op for op in open_ops if op[1] > g0]
        label = min(open_ops, key=lambda op: op[1] - op[0])[2] \
            if open_ops else "host idle"
        labels[label] = labels.get(label, 0.0) + (g1 - g0) / 1e6
    top_ops = sorted(((n, s) for n, (_, s) in by_name.items()),
                     key=lambda x: -x[1])[:10]
    top_gaps = sorted(labels.items(), key=lambda x: -x[1])[:10]
    window = (hi - lo) / 1e6
    return dict(window_s=window, busy_s=busy / 1e6,
                idle_share=max(0.0, 1.0 - busy / (hi - lo)),
                kernels=kernels,
                breakdown={"device_ops": [[n, s] for n, s in top_ops],
                           "idle_gaps": [[n, s] for n, s in top_gaps]})


# ---- statistics -------------------------------------------------------

def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks; an infinite value (a request never answered) counts
    as the slowest."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[hi]) or math.isinf(v[lo]):
        return v[hi] if pos > lo else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
