"""FVD, FID and the Inception Score — the counterpart of
`dvdgan_tpu/eval/metrics.py`.

The host-side functions (`extract_features`, `fvd`, `fid`,
`inception_score`, `compute_real_features`, `file_stamp`,
`load_or_compute_real_stats`) are copies of the reference's, numpy only.
`evaluate_generator` draws EMA-G clips on the trainer's device and scores
them against the trainer's dataset; the fakes stay on the device until the
extractors have their features.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dvdgan_tpu_torch.eval.frechet import frechet_from_features


def extract_features(extractor: Callable, clips: Iterable[np.ndarray],
                     batch_size: int = 16) -> np.ndarray:
    """Run the extractor over an iterable of clips (each (T,H,W,3) or a
    pre-batched (B,T,H,W,3)), batching for device efficiency."""
    feats = []
    buf = []
    for c in clips:
        c = np.asarray(c)
        if c.ndim == 5:
            feats.append(extractor(c))
            continue
        buf.append(c)
        if len(buf) == batch_size:
            feats.append(extractor(np.stack(buf)))
            buf = []
    if buf:
        feats.append(extractor(np.stack(buf)))
    if not feats:
        raise ValueError("no clips")
    return np.concatenate(feats)


def fvd(real_feats: np.ndarray, fake_feats: np.ndarray) -> float:
    """Fréchet Video Distance between two feature sets (N, D)."""
    return frechet_from_features(real_feats, fake_feats)


def fid(real_frame_feats: np.ndarray, fake_frame_feats: np.ndarray) -> float:
    """Fréchet Inception Distance over per-frame features (N·T, D) — same
    Fréchet math as FVD, frame-level embedding (paper's Kinetics IS/FID
    protocol uses frame statistics)."""
    return frechet_from_features(real_frame_feats, fake_frame_feats)


def inception_score(probs: np.ndarray, n_splits: int = 10
                    ) -> tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over `n_splits` splits -> (mean, std).
    probs: (N, n_classes) softmax outputs."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    splits = max(1, min(n_splits, n))
    scores = []
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def compute_real_features(ds, extractor: Callable, n: int,
                          batch_size: int = 16,
                          frame_extractor: Optional[Callable] = None
                          ) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """The real side of FVD/FID: features of the first `n` dataset clips.

    A pure function of (dataset, extractor, n) — so cache it: the trainer
    memoizes it across --eval_step evaluations and --mode eval can persist
    it to disk (--real_stats), instead of re-decoding and re-embedding the
    identical real set on every evaluation (half the scoring-network
    forwards, all of the real decodes)."""
    feats = []
    frame_feats = []
    n = min(n, len(ds))
    done = 0
    while done < n:
        b = min(batch_size, n - done)
        items = [ds[done + j] for j in range(b)]
        reals = np.stack([np.asarray(c, np.float32) for c, _ in items])
        feats.append(extractor(reals))
        if frame_extractor is not None:
            frame_feats.append(frame_extractor(reals))
        done += b
    if not feats:
        raise ValueError("no clips")
    return (np.concatenate(feats),
            np.concatenate(frame_feats) if frame_extractor is not None
            else None)


def file_stamp(path: Optional[str]) -> str:
    """Identity stamp for a weights file (basename:size:mtime_ns) for
    real-stats cache metadata — a replaced/reconverted weights npz changes
    the feature space, so it must invalidate the cache."""
    if not path:
        return "none"
    st = os.stat(path)
    return f"{os.path.basename(path)}:{st.st_size}:{st.st_mtime_ns}"


def load_or_compute_real_stats(path: str, ds, extractor: Callable, n: int,
                               batch_size: int = 16,
                               frame_extractor: Optional[Callable] = None,
                               meta: Optional[dict] = None,
                               write: bool = True
                               ) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Disk-persisted real-side features (standard FID practice). If
    `path` exists, load it — after checking every `meta` entry against the
    stamps written at save time, so stale stats from a different
    dataset/extractor/shape can't silently poison the Fréchet math.
    Otherwise compute via `compute_real_features` and (with write=True)
    save to `path`. Multi-host: pass write=False on non-leader processes —
    N processes publishing the same path would race the tmp+rename."""
    meta = meta or {}
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            for k, v in meta.items():
                got = (str(z[f"meta_{k}"]) if f"meta_{k}" in z
                       else "<absent>")
                if got != str(v):
                    raise ValueError(
                        f"real-stats {k} mismatch at {path}: cache has "
                        f"{got!r}, this run wants {v!r}")
            rff = z["frame_feats"] if "frame_feats" in z else None
            return z["feats"], rff
    rf, rff = compute_real_features(ds, extractor, n, batch_size=batch_size,
                                    frame_extractor=frame_extractor)
    if not write:
        return rf, rff
    arrays = {"feats": rf}
    if rff is not None:
        arrays["frame_feats"] = rff
    tmp = path + ".tmp"
    np.savez(tmp, **arrays,
             **{f"meta_{k}": str(v) for k, v in meta.items()})
    # np.savez appends .npz to pathless-suffix names; normalize then
    # publish atomically — an interrupted run must leave NO file at
    # `path` (a truncated zip would make every later eval crash in
    # np.load instead of recomputing)
    written = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(written, path)
    return rf, rff


def evaluate_generator(trainer, extractor: Callable, n_samples: int = 256,
                       batch_size: int = 16,
                       classifier: Optional[Callable] = None,
                       frame_extractor: Optional[Callable] = None,
                       real_features: Optional[tuple] = None,
                       sample_seed: int = 1234,
                       timing: Optional[dict] = None) -> dict:
    """EMA-G samples vs the trainer's dataset -> {"fvd"[, "fid"][,
    "is_mean", "is_std"]}.

    Synthesis (cond_frames == 0): unconditional samples vs the first n
    dataset clips. Prediction (DVD-GAN-FP): clip i is conditioned on real
    clip i's first cond_frames frames, and the features are taken over the
    whole clip (the real prefix, then the generated frames) against the
    real clips: the paper's prediction-FVD protocol.

    The draws: z, then the class ids, for each batch from a CPU
    `torch.Generator` seeded with `cfg.seed + sample_seed`, a stream of
    its own (not the train step's draws, not the loader's), so an
    evaluation changes no training bit. Another `sample_seed` gives another
    fake set (--eval_repeats). Not the reference's `jax.random` stream.

    `real_features`: `compute_real_features(...)` of this (dataset,
    extractor[, frame_extractor], n). With it the real side is not
    embedded again, and in synthesis mode not even read (prediction mode
    still reads each real clip, once, for its prefix).

    `timing`: a dict whose "sample_s" gains the seconds EMA-G's sampling
    took, each batch to the end of its work on the device."""
    ds = trainer.dataset
    cf = trainer.g_cfg.cond_frames
    n = min(n_samples, len(ds))
    if real_features is not None:
        if frame_extractor is not None and real_features[1] is None:
            raise ValueError(
                "real_features lacks frame features but a frame_extractor "
                "was requested — recompute the cache with frame_extractor")
        if real_features[0].shape[0] != n:
            raise ValueError(
                f"real_features has {real_features[0].shape[0]} clips but "
                f"this evaluation uses {n} — recompute the cache")

    # Synthesis: the real side comes first (or from the cache). Prediction:
    # each real clip also gives its fake's prefix, so it is read once
    # inside the loop and embedded there unless cached.
    inline_real = real_features is None and cf > 0
    if real_features is not None:
        rf, rff = real_features
    elif not inline_real:
        rf, rff = compute_real_features(ds, extractor, n,
                                        batch_size=batch_size,
                                        frame_extractor=frame_extractor)
    real_feats, real_frame_feats = [], []
    fake_feats, fake_frame_feats, probs = [], [], []
    device, dtype = trainer.device, trainer.dtype
    gen = torch.Generator().manual_seed(trainer.cfg.seed + sample_seed)

    def sample(*args, **kw) -> torch.Tensor:
        t = time.perf_counter()
        clip = trainer.sample(*args, **kw)
        if timing is not None:
            if clip.device.type == "cuda":
                torch.cuda.synchronize(clip.device)
            timing["sample_s"] = (timing.get("sample_s", 0.0)
                                  + time.perf_counter() - t)
        return clip

    done = 0
    while done < n:
        b = min(batch_size, n - done)
        z = torch.randn(b, trainer.g_cfg.z_dim, generator=gen)
        y = torch.randint(0, trainer.cfg.n_classes, (b,), generator=gen)
        z = z.to(device, dtype)
        with torch.no_grad():
            if cf:
                items = [ds[done + j] for j in range(b)]   # one read each
                reals = np.stack([np.asarray(c, np.float32)
                                  for c, _ in items])
                labels = torch.as_tensor([lbl for _, lbl in items])
                if inline_real:
                    real_feats.append(extractor(reals))
                    if frame_extractor is not None:
                        real_frame_feats.append(frame_extractor(reals))
                prefix = torch.from_numpy(reals[:, :cf]).to(device)
                clip = sample(z, labels.to(device), cond=prefix.to(dtype))
                fake = torch.cat([prefix, clip.float()], dim=1)
            else:
                fake = sample(z, y.to(device)).float()
        f = extractor(fake)
        fake_feats.append(f)
        if frame_extractor is not None:
            fake_frame_feats.append(frame_extractor(fake))
        if classifier is not None:
            # a classifier over THIS extractor's logits reuses them: one
            # scoring-network forward a batch, not two
            if (getattr(classifier, "fx", None) is extractor
                    and hasattr(classifier, "from_features")):
                probs.append(classifier.from_features(f))
            else:
                probs.append(classifier(fake))
        done += b
    if inline_real:
        rf = np.concatenate(real_feats)
        rff = (np.concatenate(real_frame_feats)
               if frame_extractor is not None else None)
    out = {"fvd": fvd(rf, np.concatenate(fake_feats))}
    if frame_extractor is not None:
        out["fid"] = fid(rff, np.concatenate(fake_frame_feats))
    if probs:
        m, s = inception_score(np.concatenate(probs))
        out.update(is_mean=m, is_std=s)
    return out
