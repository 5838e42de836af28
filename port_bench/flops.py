"""The yardstick: the H100's published peaks, each kernel's least time from
its operations and bytes, and the model FLOPs of a train step and of a
sampler batch, all from shapes.

`bound`, `fwd_flops`, `bwd_flops` and `fwd_bound` are frozen copies of
`chip_smoke.py`'s; `k2_kernel_flops` and `k2_bound` count only what K2's
own launches compute (the dW of both hidden convs is a cuDNN
weight-gradient outside them).

The model FLOPs count 2 per multiply-add of every convolution and matrix
product the model needs, at the work the model defines: the nearest-2×
upsample conv as the 4 taps per output pixel that a 3×3 kernel over a
duplicated map reduces to, G's level-0 GRU input conv once per clip (its
input is the seed map repeated over time), the backward as one product
for the input's gradient and one for the weight's where each is needed.
Work done again to save memory (remat) or to save a kernel's state (K2's
gate recompute) is not counted.
"""

from __future__ import annotations

import dataclasses
import math

PEAK_BYTES = 3.35e12                                   # HBM3, B/s
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}            # dense, FLOP/s
ITEMSIZE = {"f32": 4, "bf16": 2}
BASE_RES = 4
G_MULTS = {32: (4, 4, 4, 4), 64: (8, 8, 4, 2, 1), 128: (16, 16, 8, 4, 2, 1),
           256: (16, 16, 8, 8, 4, 2, 1)}
D_MULTS = {16: (2, 2, 2), 32: (2, 2, 2, 2), 64: (1, 2, 4, 8, 16),
           128: (1, 2, 4, 8, 16, 16), 256: (1, 2, 4, 8, 8, 16, 16)}
K3_MIN_PIXELS = 64 * 64        # the planes the program gives K3, not K1


# ------------------------------------------------------ kernel bounds --

def bound(flops: float, n_bytes: float, dtype: str) -> float:
    """The least time in ms: the larger of bytes over the memory rate and
    operations over the peak rate for the operand type."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES) * 1e3


def fwd_flops(t, b, h, w, c) -> float:
    """K1's and K3's operations: the two hidden-side 3×3 convs per step."""
    return 2 * 9 * t * b * h * w * c * 3 * c


def bwd_flops(t, b, h, w, c) -> float:
    """K2 with its weight gradients: the gate and candidate recompute
    (3C), the two transposed convs (C + 2C), the two dW (2C + C)."""
    return 2 * 9 * t * b * h * w * c * 9 * c


def k2_kernel_flops(t, b, h, w, c) -> float:
    """What K2's launches compute: the recompute and the transposed convs
    (6C a pixel); the dW products run outside them."""
    return 2 * 9 * t * b * h * w * c * 6 * c


def fwd_bound(t, b, h, w, c, dtype: str) -> float:
    """K1's and K3's: gx, cx, h0 and the weights read once, hs written."""
    px = t * b * h * w
    n_el = px * 3 * c + b * h * w * c + 27 * c * c + px * c
    return bound(fwd_flops(t, b, h, w, c), n_el * ITEMSIZE[dtype], dtype)


def k2_bound(t, b, h, w, c, dtype: str) -> float:
    """K2's launches alone: gx, cx, h0, the weights, hs and g read; dgx,
    dcx and dh0 written."""
    px = t * b * h * w
    n_el = (px * 3 * c + b * h * w * c + 27 * c * c + 2 * px * c
            + px * 3 * c + b * h * w * c)
    return bound(k2_kernel_flops(t, b, h, w, c), n_el * ITEMSIZE[dtype],
                 dtype)


# ------------------------------------------------------------- shapes --

@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the counts need, from a configuration's flags."""
    img_size: int
    n_frames: int
    ch: int
    d_ch: int
    z_dim: int
    emb_dim: int
    attn_res: int
    k_frames: int
    d_steps: int = 2
    grad_accum: int = 1

    @classmethod
    def of(cls, flags: dict) -> "Shape":
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in flags.items() if k in keys})

    @property
    def n_levels(self) -> int:
        return int(math.log2(self.img_size // BASE_RES))

    @property
    def cond_dim(self) -> int:
        return self.z_dim // (self.n_levels + 1) + self.emb_dim

    def g_width(self, i: int) -> int:
        return self.ch * G_MULTS[self.img_size][i]

    def gru_levels(self) -> list[tuple[int, int, int]]:
        """(H, W, C) of each level's GRU plane."""
        return [(BASE_RES << i, BASE_RES << i, self.g_width(i))
                for i in range(self.n_levels)]


# A layer's multiply-adds at unit batch, with whether its input needs a
# gradient in a backward through it.
@dataclasses.dataclass
class Layer:
    name: str
    macs: float
    input_grad: bool = True


def g_layers(s: Shape, b: int) -> list[Layer]:
    """G's forward at batch b."""
    t = s.n_frames
    c0 = s.g_width(0)
    out = [Layer("g.seed", b * (s.z_dim // (s.n_levels + 1))
                 * BASE_RES ** 2 * c0, input_grad=False)]
    res = BASE_RES
    for i in range(s.n_levels):
        cin, cout = s.g_width(i), s.g_width(i + 1)
        n_in = b if i == 0 else t * b
        px = res * res
        out += [Layer(f"g.{i}.gru_input", n_in * px * 9 * cin * 3 * cin),
                Layer(f"g.{i}.gru_hidden", t * b * px * 9 * cin * 3 * cin),
                Layer(f"g.{i}.cbn1", t * b * 2 * s.cond_dim * cin),
                Layer(f"g.{i}.ups_conv", t * b * 4 * px * 4 * cin * cout),
                Layer(f"g.{i}.cbn2", t * b * 2 * s.cond_dim * cout),
                Layer(f"g.{i}.conv2", t * b * 4 * px * 9 * cout * cout)]
        if cin != cout:
            out.append(Layer(f"g.{i}.skip", t * b * px * cin * cout))
        res *= 2
        if res == s.attn_res:
            hw, kv, c = res * res, res * res // 4, cout
            spatial = (hw * c * c // 8 + kv * c * (c // 8 + c // 2)
                       + hw * kv * (c // 8 + c // 2) + hw * c // 2 * c)
            temporal = (t * c * (c // 8 * 2 + c // 2) + t * t * (c // 8
                        + c // 2) + t * c // 2 * c)
            out += [Layer("g.attn_spatial", t * b * spatial),
                    Layer("g.attn_temporal", b * hw * temporal)]
    c_last = s.g_width(s.n_levels)
    out.append(Layer("g.out_conv", t * b * res * res * 9 * c_last * 3))
    return out


def _d_blocks(prefix: str, widths, size: int, n: int, frames: int,
              three_d: int, first_input_grad: bool) -> list[Layer]:
    """BigGAN-D blocks over n items of `frames` frames each at `size`²;
    the first `three_d` blocks take 3×3×3 kernels over time."""
    out, cin, res = [], 3, size
    for i, cout in enumerate(widths):
        k = 27 if i < three_d else 9
        down = i < len(widths) - 1
        px = n * frames * res * res
        grad_in = first_input_grad or i > 0
        out += [Layer(f"{prefix}.{i}.conv1", px * k * cin * cout, grad_in),
                Layer(f"{prefix}.{i}.conv2", px * k * cout * cout)]
        if i == 0 or cin != cout:
            px_skip = px // 4 if down else px
            out.append(Layer(f"{prefix}.{i}.skip", px_skip * cin * cout,
                             grad_in))
        if down:
            res //= 2
        cin = cout
    return out


def d_layers(s: Shape, b: int, input_grad: bool) -> list[Layer]:
    """DS on b clips' k frames and DT on b whole clips at half size."""
    ds_w = [s.d_ch * m for m in D_MULTS[s.img_size]]
    dt_w = [s.d_ch * m for m in D_MULTS[s.img_size // 2]]
    out = _d_blocks("ds", ds_w, s.img_size, b, s.k_frames, 0, input_grad)
    out += _d_blocks("dt", dt_w, s.img_size // 2, b, s.n_frames, 2,
                     input_grad)
    out += [Layer("ds.head", b * s.k_frames * ds_w[-1]),
            Layer("dt.head", b * s.n_frames * dt_w[-1])]
    return out


def fwd(layers: list[Layer]) -> float:
    return 2 * sum(l.macs for l in layers)


def bwd(layers: list[Layer], weights: bool) -> float:
    """dX where the input needs it, dW where `weights`."""
    return 2 * sum(l.macs * (int(l.input_grad) + int(weights))
                   for l in layers)


def train_step_flops(s: Shape, b: int) -> dict[str, float]:
    """Model FLOPs of one train step at batch b, by phase: G's pooled fake
    pass (batch d_steps·b, no grad), d_steps D updates on real + fake
    (forward and backward), and the G update through D (D's input
    gradient only, G's input and weight gradients)."""
    d = s.d_steps
    return {
        "fake_pass": fwd(g_layers(s, d * b)),
        "d_updates": d * (fwd(d_layers(s, 2 * b, False))
                          + bwd(d_layers(s, 2 * b, False), weights=True)),
        "g_update": (fwd(g_layers(s, b)) + fwd(d_layers(s, b, True))
                     + bwd(d_layers(s, b, True), weights=False)
                     + bwd(g_layers(s, b), weights=True)),
    }


def sample_flops(s: Shape, b: int) -> float:
    """Model FLOPs of one sampler batch: G's forward."""
    return fwd(g_layers(s, b))


# ---------------------------------------------------------- K1, K2, K3 --

def gru_calls(s: Shape, b: int, train: bool) -> list[tuple[str, tuple]]:
    """(kernel, (T, B, H, W, C)) of every whole-sequence GRU launch group
    in one step (train) or one sampler batch at batch b: K3 where the
    plane has at least K3_MIN_PIXELS pixels, else K1; K2 for each
    backward."""
    fwd_kernel = lambda h, w: "k3" if h * w >= K3_MIN_PIXELS else "k1"
    t = s.n_frames
    out = []
    if not train:
        for h, w, c in s.gru_levels():
            out.append((fwd_kernel(h, w), (t, b, h, w, c)))
        return out
    micro = b // s.grad_accum
    for h, w, c in s.gru_levels():
        out.append((fwd_kernel(h, w), (t, s.d_steps * b, h, w, c)))
        for _ in range(s.grad_accum):
            out.append((fwd_kernel(h, w), (t, micro, h, w, c)))
            out.append(("k2", (t, micro, h, w, c)))
    return out


def gru_bound_ms(s: Shape, b: int, train: bool, dtype: str) -> float:
    """Σ of K1, K2 (its launches) and K3's bounds over a step or batch."""
    total = 0.0
    for kernel, shape in gru_calls(s, b, train):
        total += (k2_bound(*shape, dtype) if kernel == "k2"
                  else fwd_bound(*shape, dtype))
    return total
