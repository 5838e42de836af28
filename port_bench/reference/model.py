"""Plain PyTorch reference of DVD-GAN's train step and sampler.

Written from the model's equations (DVD-GAN, arXiv:1907.06571, with the
BigGAN blocks it builds on), independent of the program under test: it
imports torch alone. Layout NCHW (NCDHW for DT's 3-D blocks); parameters
are read from one flat dict {path: tensor} whose paths and HWIO / DHWIO /
(in, out) shapes are the state's, so the benchmark can make one set of
weights and hand it to both sides.

    G:  z → n_levels + 1 chunks; SNLinear(chunk 0) → 4×4 map, repeated over
        T; each level: ConvGRU over T (rz = σ(Wx*x + Wh*h), c = tanh(Wx'*x +
        Wh'*(r⊙h)), h = (1−z)h + z·c, h0 = 0), then a GResBlock (CBN → ReLU →
        nearest 2× → conv3×3 → CBN → ReLU → conv3×3, skip conv1×1 → 2×) on
        the frames, conditioned per clip on [chunk, embed(y)]; separable
        attention (spatial over the frame with 2×2-max-pooled keys, then
        temporal) after the level that reaches attn_res; BN → ReLU → conv →
        tanh.
    DS: k frames per clip through BigGAN-D blocks, ReLU, sum pool, linear +
        projection on embed(y), summed over the k frames.
    DT: the clip 2×2-mean-pooled, 3×3×3 blocks then 2-D blocks with time
        folded, the same head, summed over frames.
    Spectral norm on every kernel and embedding (one power iteration per
    call), hinge losses, Adam (β1 = 0), EMA.

`prec` selects the arithmetic: "f32" (the reference; TF32 off while it
runs), "fp8" (the control: every operand of a convolution or matrix
product rounded to float8 e4m3 with a per-tensor scale, sums in f32, the
backward in f32 through the rounding) or "bf16" (the same operands rounded
to bfloat16: a witness of what the program's bf16 arithmetic does to the
compared numbers). `fault` plants a defect for the calibration of the
limits (`FAULTS`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

G_MULTS = {32: (4, 4, 4, 4), 64: (8, 8, 4, 2, 1), 128: (16, 16, 8, 4, 2, 1),
           256: (16, 16, 8, 8, 4, 2, 1)}
D_MULTS = {16: (2, 2, 2), 32: (2, 2, 2, 2), 64: (1, 2, 4, 8, 16),
           128: (1, 2, 4, 8, 16, 16), 256: (1, 2, 4, 8, 8, 16, 16)}
BASE_RES = 4
N_3D_BLOCKS = 2
BN_MOMENTUM = 0.1
BN_EPS = 1e-5
SN_EPS = 1e-12
ADAM_EPS = 1e-8
FP8_MAX = 448.0
_MASK64 = (1 << 64) - 1
# the planes the program's blocked sequence kernel (K3) takes: 64×64 and up
K3_PIXELS = 64 * 64
FAULTS = {
    "half_batch": "every batch scored and averaged over its first half",
    "d_lr": "DS's and DT's Adam steps taken at G's learning rate",
    "ema_decay": "EMA steps ten times too large: decay 1 - 10(1 - decay)",
    "g_flip": "G's gradient negated before its Adam step",
    "no_carry": "the GRU on planes of K3_PIXELS and up restarts from h = 0 "
                "at every frame",
}


@dataclasses.dataclass(frozen=True)
class Spec:
    """The model and the step, from a configuration's flags."""
    img_size: int
    n_frames: int
    ch: int
    d_ch: int
    z_dim: int
    n_classes: int
    emb_dim: int
    attn_res: int
    k_frames: int
    d_steps: int = 2
    grad_accum: int = 1
    lr_g: float = 1e-4
    lr_d: float = 5e-4
    beta1: float = 0.0
    beta2: float = 0.999
    ema_decay: float = 0.9999
    ema_start: int = 1000

    @property
    def n_levels(self) -> int:
        return int(math.log2(self.img_size // BASE_RES))

    @property
    def chunk(self) -> int:
        return self.z_dim // (self.n_levels + 1)

    @property
    def cond_dim(self) -> int:
        return self.chunk + self.emb_dim

    def g_width(self, i: int) -> int:
        return self.ch * G_MULTS[self.img_size][i]

    @property
    def attn_level(self) -> Optional[int]:
        """The level whose output resolution is attn_res, or None."""
        res = BASE_RES
        for i in range(self.n_levels):
            res *= 2
            if res == self.attn_res:
                return i
        return None

    def d_widths(self, size: int) -> list[int]:
        return [self.d_ch * m for m in D_MULTS[size]]


def spec_from_flags(flags: dict) -> Spec:
    """A Spec from a configuration's port flags (the CLI's names)."""
    keys = {f.name for f in dataclasses.fields(Spec)}
    return Spec(**{k: v for k, v in flags.items() if k in keys})


# ------------------------------------------------------------- the shapes --

def param_shapes(s: Spec) -> dict[str, dict[str, tuple]]:
    """{model: {path: shape}} of G, DS and DT's parameters."""
    g: dict[str, tuple] = {"embed/emb": (s.n_classes, s.emb_dim),
                           "seed/w": (s.chunk, BASE_RES ** 2 * s.g_width(0)),
                           "seed/b": (BASE_RES ** 2 * s.g_width(0),)}
    for i in range(s.n_levels):
        cin, cout = s.g_width(i), s.g_width(i + 1)
        p = f"levels/{i}/"
        g[p + "gru/gates_x/w"] = (3, 3, cin, 2 * cin)
        g[p + "gru/gates_x/b"] = (2 * cin,)
        g[p + "gru/gates_h/w"] = (3, 3, cin, 2 * cin)
        g[p + "gru/cand_x/w"] = (3, 3, cin, cin)
        g[p + "gru/cand_x/b"] = (cin,)
        g[p + "gru/cand_h/w"] = (3, 3, cin, cin)
        for name, c in (("cbn1", cin), ("cbn2", cout)):
            g[p + f"block/{name}/gamma/w"] = (s.cond_dim, c)
            g[p + f"block/{name}/beta/w"] = (s.cond_dim, c)
        g[p + "block/conv1/w"] = (3, 3, cin, cout)
        g[p + "block/conv1/b"] = (cout,)
        g[p + "block/conv2/w"] = (3, 3, cout, cout)
        g[p + "block/conv2/b"] = (cout,)
        if cin != cout:
            g[p + "block/skip/w"] = (1, 1, cin, cout)
            g[p + "block/skip/b"] = (cout,)
    c_last = s.g_width(s.n_levels)
    g["out_bn/scale"] = (c_last,)
    g["out_bn/bias"] = (c_last,)
    g["out_conv/w"] = (3, 3, c_last, 3)
    g["out_conv/b"] = (3,)
    if s.attn_level is not None:
        c = s.g_width(s.attn_level + 1)
        for kind in ("spatial", "temporal"):
            p = f"attn/{kind}/"
            g[p + "theta/w"] = (c, c // 8)
            g[p + "phi/w"] = (c, c // 8)
            g[p + "g/w"] = (c, c // 2)
            g[p + "out/w"] = (c // 2, c)
            g[p + "gamma"] = ()
    return {"g": g, "ds": _d_shapes(s, s.img_size, three_d=0),
            "dt": _d_shapes(s, s.img_size // 2, three_d=N_3D_BLOCKS)}


def _d_shapes(s: Spec, size: int, three_d: int) -> dict[str, tuple]:
    widths = s.d_widths(size)
    out: dict[str, tuple] = {}
    cin = 3
    for i, cout in enumerate(widths):
        k = (3, 3, 3) if i < three_d else (3, 3)
        one = (1,) * len(k)
        p = f"blocks/{i}/"
        out[p + "conv1/w"] = (*k, cin, cout)
        out[p + "conv1/b"] = (cout,)
        out[p + "conv2/w"] = (*k, cout, cout)
        out[p + "conv2/b"] = (cout,)
        if i == 0 or cin != cout:
            out[p + "skip/w"] = (*one, cin, cout)
            out[p + "skip/b"] = (cout,)
        cin = cout
    out["head/psi/w"] = (widths[-1], 1)
    out["head/psi/b"] = (1,)
    out["head/proj/emb"] = (s.n_classes, widths[-1])
    return out


def stat_shapes(s: Spec) -> dict[str, tuple]:
    """G's BN running moments {path: shape}."""
    out: dict[str, tuple] = {}
    for i in range(s.n_levels):
        for name, c in (("bn1", s.g_width(i)), ("bn2", s.g_width(i + 1))):
            out[f"levels/{i}/{name}/mean"] = (c,)
            out[f"levels/{i}/{name}/var"] = (c,)
    c = s.g_width(s.n_levels)
    out["out_bn/mean"] = (c,)
    out["out_bn/var"] = (c,)
    return out


def is_sn(path: str) -> bool:
    """Spectral norm applies to every kernel and embedding."""
    return path.rsplit("/", 1)[-1] in ("w", "emb")


# ----------------------------------------------------------------- draws --

def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of a step's noise, as the program's contract
    states it: splitmix64(splitmix64(seed) + step)."""
    return splitmix64((splitmix64(seed) + step) & _MASK64)


def step_draws(seed: int, step: int, s: Spec, batch: int, dtype,
               device) -> dict:
    """The noise of one train step, in the program's draw order: the D
    steps' z, then each D step's real and fake frame indices, then G's z
    and frame indices. z in the compute dtype, then f32."""
    gen = torch.Generator(device).manual_seed(step_seed(seed, step))

    def z():
        return torch.randn(batch, s.z_dim, generator=gen, device=device,
                           dtype=dtype).float()

    def idx():
        u = torch.rand(batch, s.n_frames, generator=gen, device=device)
        return u.argsort(dim=1)[:, :s.k_frames]

    zs = [z() for _ in range(s.d_steps)]
    idxs = [(idx(), idx()) for _ in range(s.d_steps)]
    return {"d_z": zs, "d_idx": idxs, "g_z": z(), "g_idx": idx()}


# ---------------------------------------------------------- arithmetic --

class Prec:
    """The arithmetic of convolution and matrix-product operands."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8", "bf16"):
            raise ValueError(f"prec must be f32, fp8 or bf16, got {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        if self.mode == "bf16":
            q = x.detach().to(torch.bfloat16).float()
            return x + (q - x).detach()
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (q - x).detach()


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def conv(x, w, b, q: Prec):
    """SAME, stride-1 conv of x (N, C, *spatial) with an HWIO / DHWIO
    kernel (odd sizes) and an optional bias."""
    nd = w.dim() - 2
    wt = w.permute(nd + 1, nd, *range(nd))
    pad = tuple(k // 2 for k in w.shape[:nd])
    fn = F.conv2d if nd == 2 else F.conv3d
    return fn(q(x), q(wt), b, padding=pad)


def linear(x, w, b, q: Prec):
    y = q(x) @ q(w)
    return y if b is None else y + b


def up2(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def pool2(x):
    """2×2 mean pool of the last two dims."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def moments(x):
    """Biased batch mean and variance per channel (dim 1)."""
    dims = [d for d in range(x.dim()) if d != 1]
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
    return mean, var


def bshape(v, x):
    return v.reshape(1, -1, *([1] * (x.dim() - 2)))


def batch_norm(x, stats, train):
    """-> (normalized x, the moments used, new running moments)."""
    if train:
        mean, var = moments(x)
        new = {"mean": (1 - BN_MOMENTUM) * stats["mean"] + BN_MOMENTUM * mean,
               "var": (1 - BN_MOMENTUM) * stats["var"] + BN_MOMENTUM * var}
    else:
        mean, var, new = stats["mean"], stats["var"], stats
    y = (x - bshape(mean, x)) * bshape(torch.rsqrt(var + BN_EPS), x)
    return y, new


# -------------------------------------------------------- spectral norm --

def _l2n(v):
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


def spectral_norm(params: dict, u: dict, update: bool) -> tuple[dict, dict]:
    """Every kernel and embedding divided by its top singular value from
    one power iteration on the stored u (viewed (fan_in, out)); the new u
    where `update`, else the stored one."""
    out, new_u = {}, {}
    for path, w in params.items():
        if path not in u:
            out[path] = w
            continue
        m = w.reshape(-1, w.shape[-1])
        with torch.no_grad():
            v = _l2n(m @ u[path])
            u1 = _l2n(m.T @ v)
            v = _l2n(m @ u1)
        sigma = v @ (m @ u1)
        out[path] = w / sigma
        new_u[path] = u1 if update else u[path]
    return out, new_u


# -------------------------------------------------------------- networks --

def _gru(P, p, x_seq, q, carry: bool = True):
    """x_seq (B, T, C, H, W) -> hidden sequence, h0 = 0; without `carry`
    every frame starts from h0 (the fault "no_carry")."""
    b, t, c = x_seq.shape[:3]
    h0 = h = torch.zeros_like(x_seq[:, 0])
    hs = []
    for i in range(t):
        x = x_seq[:, i]
        if not carry:
            h = h0
        rz = torch.sigmoid(conv(x, P[p + "gates_x/w"], P[p + "gates_x/b"], q)
                           + conv(h, P[p + "gates_h/w"], None, q))
        r, z = rz[:, :c], rz[:, c:]
        cand = torch.tanh(conv(x, P[p + "cand_x/w"], P[p + "cand_x/b"], q)
                          + conv(r * h, P[p + "cand_h/w"], None, q))
        h = (1 - z) * h + z * cand
        hs.append(h)
    return torch.stack(hs, dim=1)


def _cbn(P, p, x, cond, stats, train, q):
    y, new = batch_norm(x, stats, train)
    gamma = 1 + linear(cond, P[p + "gamma/w"], None, q)
    beta = linear(cond, P[p + "beta/w"], None, q)
    return y * gamma[:, :, None, None] + beta[:, :, None, None], new


def _attend(P, p, xq, xkv, q):
    """Single-head attention, no 1/√d, the γ-scaled delta. (N, L, C)."""
    qq = linear(xq, P[p + "theta/w"], None, q)
    kk = linear(xkv, P[p + "phi/w"], None, q)
    vv = linear(xkv, P[p + "g/w"], None, q)
    attn = torch.softmax(q(qq) @ q(kk).transpose(1, 2), dim=-1)
    return P[p + "gamma"] * linear(q(attn) @ q(vv), P[p + "out/w"], None, q)


def _attention(P, x, q):
    """Separable attention on x (B, T, C, H, W)."""
    b, t, c, h, w = x.shape
    tok = x.reshape(b * t, c, h * w).transpose(1, 2)
    kv = F.max_pool2d(x.reshape(b * t, c, h, w), 2)
    kv = kv.reshape(b * t, c, -1).transpose(1, 2)
    tok = tok + _attend(P, "attn/spatial/", tok, kv, q)
    x = tok.transpose(1, 2).reshape(b, t, c, h, w)
    tt = x.permute(0, 3, 4, 1, 2).reshape(b * h * w, t, c)
    tt = tt + _attend(P, "attn/temporal/", tt, tt, q)
    return tt.reshape(b, h, w, t, c).permute(0, 3, 4, 1, 2)


def generator(P, stats, z, y, s: Spec, train: bool, q: Prec,
              fault: Optional[str] = None):
    """-> (video (B, T, H, W, 3) in [-1, 1], new running moments)."""
    b, t = z.shape[0], s.n_frames
    e = P["embed/emb"][y]
    chunks = torch.split(z, s.chunk, dim=-1)
    c0 = s.g_width(0)
    x = linear(chunks[0], P["seed/w"], P["seed/b"], q)
    x = x.reshape(b, BASE_RES, BASE_RES, c0).permute(0, 3, 1, 2)
    x_seq = x[:, None].expand(b, t, *x.shape[1:])
    new_stats = {}
    for i in range(s.n_levels):
        p = f"levels/{i}/"
        cond = torch.cat([chunks[i + 1], e], dim=-1).repeat_interleave(t, 0)
        plane = x_seq.shape[-2] * x_seq.shape[-1]
        hs = _gru(P, p + "gru/", x_seq, q,
                  carry=not (fault == "no_carry" and plane >= K3_PIXELS))
        hf = hs.reshape(b * t, *hs.shape[2:])
        bp = p + "block/"
        a, new_stats[p + "bn1"] = _cbn(P, bp + "cbn1/", hf, cond,
                                       _st(stats, p + "bn1"), train, q)
        a = conv(up2(torch.relu(a)), P[bp + "conv1/w"], P[bp + "conv1/b"], q)
        a, new_stats[p + "bn2"] = _cbn(P, bp + "cbn2/", a, cond,
                                       _st(stats, p + "bn2"), train, q)
        a = conv(torch.relu(a), P[bp + "conv2/w"], P[bp + "conv2/b"], q)
        sc = hf
        if bp + "skip/w" in P:
            sc = conv(sc, P[bp + "skip/w"], P[bp + "skip/b"], q)
        out = a + up2(sc)
        x_seq = out.reshape(b, t, *out.shape[1:])
        if i == s.attn_level:
            x_seq = _attention(P, x_seq, q)
    h = x_seq.reshape(b * t, *x_seq.shape[2:])
    h, new_stats["out_bn"] = batch_norm(h, _st(stats, "out_bn"), train)
    h = h * bshape(P["out_bn/scale"], h) + bshape(P["out_bn/bias"], h)
    h = conv(torch.relu(h), P["out_conv/w"], P["out_conv/b"], q)
    video = torch.tanh(h).reshape(b, t, 3, *h.shape[2:])
    stats_out = {}
    for k, v in new_stats.items():
        stats_out[k + "/mean"], stats_out[k + "/var"] = v["mean"], v["var"]
    return video.permute(0, 1, 3, 4, 2), stats_out


def _st(stats, prefix):
    return {"mean": stats[prefix + "/mean"], "var": stats[prefix + "/var"]}


def _dblocks(P, x, n, start, down_until, three_d: bool, q):
    for i in range(start, start + n):
        p = f"blocks/{i}/"
        h = x if i == 0 else torch.relu(x)
        h = conv(h, P[p + "conv1/w"], P[p + "conv1/b"], q)
        h = conv(torch.relu(h), P[p + "conv2/w"], P[p + "conv2/b"], q)
        sc = x
        if i < down_until:
            h, sc = pool2(h), pool2(sc)
        if p + "skip/w" in P:
            sc = conv(sc, P[p + "skip/w"], P[p + "skip/b"], q)
        x = h + sc
    return x


def _head(P, feats, y, q):
    out = linear(feats, P["head/psi/w"], P["head/psi/b"], q)[:, 0]
    return out + (P["head/proj/emb"][y] * feats).sum(-1)


def ds_score(P, frames, y, q):
    """frames (B, k, H, W, 3) -> per-clip score (B,)."""
    b, k = frames.shape[:2]
    x = frames.reshape(b * k, *frames.shape[2:]).permute(0, 3, 1, 2)
    n = sum(1 for p in P if p.endswith("/conv1/w"))
    x = _dblocks(P, x, n, 0, n - 1, False, q)
    feats = torch.relu(x).sum(dim=(2, 3))
    return _head(P, feats, y.repeat_interleave(k), q).reshape(b, k).sum(1)


def dt_score(P, pooled, y, q):
    """pooled (B, T, H/2, W/2, 3) -> per-clip score (B,)."""
    b, t = pooled.shape[:2]
    n = sum(1 for p in P if p.endswith("/conv1/w"))
    x = pooled.permute(0, 4, 1, 2, 3)                      # (B, 3, T, H, W)
    x = _dblocks(P, x, N_3D_BLOCKS, 0, n - 1, True, q)
    x = x.transpose(1, 2).reshape(b * t, x.shape[1], *x.shape[3:])
    x = _dblocks(P, x, n - N_3D_BLOCKS, N_3D_BLOCKS, n - 1, False, q)
    feats = torch.relu(x).sum(dim=(2, 3))
    return _head(P, feats, y.repeat_interleave(t), q).reshape(b, t).sum(1)


def phi(video):
    """DT's input: each frame 2×2-mean-pooled. (B, T, H, W, 3)."""
    return pool2(video.permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)


def take(video, idx):
    rows = torch.arange(video.shape[0], device=video.device)[:, None]
    return video[rows, idx]


def d_hinge(real, fake):
    return torch.relu(1 - real).mean() + torch.relu(1 + fake).mean()


# ------------------------------------------------------------------ step --

def adam(params, grads, opt, lr, s: Spec):
    count = opt["count"] + 1
    n = count.float()
    bc1 = 1 - s.beta1 ** n
    bc2 = 1 - s.beta2 ** n
    mu, nu, new = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1 - s.beta1) * g + s.beta1 * opt["mu"][k]
        nu[k] = (1 - s.beta2) * g * g + s.beta2 * opt["nu"][k]
        new[k] = p - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
    return new, {"count": count, "mu": mu, "nu": nu}


def _grad(loss, params):
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys],
                             allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g)
            for k, g in zip(keys, gs)}


def _leaves(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def train_step(st: dict, real, y, draws: dict, s: Spec, q: Prec,
               fault: Optional[str] = None) -> tuple[dict, dict, dict]:
    """One step of the alternating hinge-loss loop: d_steps D updates on
    G's pooled fakes (one G forward at batch d_steps·B, no grad), then one
    G update through D, then EMA. `st`: {"step": int, "g": {"params",
    "stats", "sn_u", "opt"}, "ds", "dt": {"params", "sn_u", "opt"},
    "g_ema"}, flat dicts of f32 tensors; real (B, T, H, W, 3) f32; draws
    from `step_draws`; `fault` one of FAULTS or None. -> (new state,
    metrics, {model: the gradient the optimizer took, the last D update's
    for DS and DT})."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "half_batch":
        h = real.shape[0] // 2
        real, y = real[:h], y[:h]
        draws = {"d_z": [z[:h] for z in draws["d_z"]],
                 "d_idx": [(a[:h], b[:h]) for a, b in draws["d_idx"]],
                 "g_z": draws["g_z"][:h], "g_idx": draws["g_idx"][:h]}
    b = real.shape[0]
    k = s.grad_accum
    m = b // k
    d = s.d_steps
    g, ds, dt = st["g"], st["ds"], st["dt"]
    with torch.no_grad():
        g_sn, _ = spectral_norm(g["params"], g["sn_u"], update=False)
        fake_all, _ = generator(g_sn, g["stats"], torch.cat(draws["d_z"]),
                                y.repeat(d), s, True, q, fault)
        real_dt, fake_all_dt = phi(real), phi(fake_all)
    metrics, grads_seen = {}, {}
    for i in range(d):
        ridx, fidx = draws["d_idx"][i]
        rf = take(real, ridx)
        ff = take(fake_all[i * b:(i + 1) * b], fidx)
        fdt = fake_all_dt[i * b:(i + 1) * b]
        acc, l_s, l_t = None, [], []
        for j in range(k):
            sl = slice(j * m, (j + 1) * m)
            ps, pt = _leaves(ds["params"]), _leaves(dt["params"])
            with torch.enable_grad():
                ds_sn, ds_u = spectral_norm(ps, ds["sn_u"], update=True)
                dt_sn, dt_u = spectral_norm(pt, dt["sn_u"], update=True)
                yy = torch.cat([y[sl], y[sl]])
                s_ds = ds_score(ds_sn, torch.cat([rf[sl], ff[sl]]), yy, q)
                s_dt = dt_score(dt_sn, torch.cat([real_dt[sl], fdt[sl]]), yy,
                                q)
                ls, lt = (d_hinge(s_ds[:m], s_ds[m:]),
                          d_hinge(s_dt[:m], s_dt[m:]))
            gr = _grad(ls + lt, {**{"ds/" + p: v for p, v in ps.items()},
                                 **{"dt/" + p: v for p, v in pt.items()}})
            acc = gr if acc is None else {p: acc[p] + gr[p] for p in acc}
            l_s.append(ls.detach())
            l_t.append(lt.detach())
        acc = {p: v / k for p, v in acc.items()}
        gds = {p[3:]: v for p, v in acc.items() if p.startswith("ds/")}
        gdt = {p[3:]: v for p, v in acc.items() if p.startswith("dt/")}
        lr_d = s.lr_g if fault == "d_lr" else s.lr_d
        nds, ods = adam(ds["params"], gds, ds["opt"], lr_d, s)
        ndt, odt = adam(dt["params"], gdt, dt["opt"], lr_d, s)
        ds = {"params": nds, "sn_u": ds_u, "opt": ods}
        dt = {"params": ndt, "sn_u": dt_u, "opt": odt}
        ls_m, lt_m = torch.stack(l_s).mean(), torch.stack(l_t).mean()
        metrics.update(d_loss=ls_m + lt_m, d_loss_s=ls_m, d_loss_t=lt_m)
        grads_seen["ds"], grads_seen["dt"] = gds, gdt

    with torch.no_grad():
        ds_sn, _ = spectral_norm(ds["params"], ds["sn_u"], update=False)
        dt_sn, _ = spectral_norm(dt["params"], dt["sn_u"], update=False)
    acc, losses, micro_stats = None, [], []
    for j in range(k):
        sl = slice(j * m, (j + 1) * m)
        pg = _leaves(g["params"])
        with torch.enable_grad():
            g_sn, g_u = spectral_norm(pg, g["sn_u"], update=True)
            fake, stats = generator(g_sn, g["stats"], draws["g_z"][sl],
                                    y[sl], s, True, q, fault)
            s_ds = ds_score(ds_sn, take(fake, draws["g_idx"][sl]), y[sl], q)
            s_dt = dt_score(dt_sn, phi(fake), y[sl], q)
            loss = -s_ds.mean() - s_dt.mean()
        gr = _grad(loss, pg)
        acc = gr if acc is None else {p: acc[p] + gr[p] for p in acc}
        losses.append(loss.detach())
        micro_stats.append({p: v.detach() for p, v in stats.items()})
    acc = {p: v / k * (-1 if fault == "g_flip" else 1)
           for p, v in acc.items()}
    g_stats = {p: torch.stack([ms[p] for ms in micro_stats]).mean(0)
               for p in micro_stats[0]}
    ng, og = adam(g["params"], acc, g["opt"], s.lr_g, s)
    decay = s.ema_decay if st["step"] >= s.ema_start else 0.0
    if fault == "ema_decay":
        decay = 1 - 10 * (1 - decay) if decay else decay
    ema = {p: decay * e + (1 - decay) * ng[p] for p, e in st["g_ema"].items()}
    metrics["g_loss"] = torch.stack(losses).mean()
    grads_seen["g"] = acc
    new = {"step": st["step"] + 1,
           "g": {"params": ng, "stats": g_stats, "sn_u": g_u, "opt": og},
           "ds": ds, "dt": dt, "g_ema": ema}
    return new, metrics, grads_seen


@torch.no_grad()
def sample(g_ema: dict, stats: dict, sn_u: dict, z, y, s: Spec, q: Prec):
    """The sampler: EMA weights, running moments, SN from the stored u
    (not advanced). z f32 -> (B, T, H, W, 3)."""
    p, _ = spectral_norm(g_ema, sn_u, update=False)
    return generator(p, stats, z, y, s, False, q)[0]
