"""The port's evaluation harness (`dvdgan_tpu_torch/eval/{frechet,metrics,
features}.py`, `Trainer.evaluate`, `--eval_step`, `--mode eval`) against
the reference's `dvdgan_tpu/eval`, on the CPU at the repo's test scale
(img 32, T 4, ch 8, 3 classes, f32).

Fréchet statistics and the Inception Score are the reference's bitwise on
the same float64 inputs. `I3DLikeFeatures` (widths (8, 16): D = 16) and
`ClassifierProbs` carry the reference's weights and agree within 1e-4 ×
max|ref|. `evaluate_generator` on a port `Trainer` scores 24 clips (> D,
so the covariances have full rank): its fvd, fid and is_mean equal, within
rtol 1e-4, the reference's metrics computed by the reference's extractors
on the same real clips (the port's synthetic dataset is the reference's)
and on the port's fakes, captured from `Trainer.sample`. The rest holds
the port to the reference's contracts: the prediction protocol reads each
clip once and scores prefix + generated frames, the real-side cache skips
the dataset and refuses a wrong one, `Trainer.evaluate` keeps its real
side, the stats file round-trips and checks its stamps, another sample
seed gives other fakes, `--eval_step` leaves a run's bits as they were
(K 1 and K 2), and `--mode eval` prints the reference's JSON keys.
"""

from __future__ import annotations

import collections
import functools
import json
import os

import numpy as np
import pytest
import torch

from dvdgan_tpu.eval import features as jfeatures
from dvdgan_tpu.eval import frechet as jfrechet
from dvdgan_tpu.eval import metrics as jmetrics
from dvdgan_tpu_torch import cli, interop
from dvdgan_tpu_torch.eval import features, frechet, metrics
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import logging as plogging
from dvdgan_tpu_torch.utils.config import Config

KW = dict(dataset="synthetic", n_classes=3, img_size=32, n_frames=4, ch=8,
          d_ch=8, k_frames=2, batch_size=2, d_steps=1, bf16=False, seed=3,
          device="cpu", log_step=100, sample_step=0, model_save_step=0)
WIDTHS = (8, 16)
# the keys of the reference's --mode eval line (main.py)
EVAL_KEYS = {"fvd", "fid", "is_mean", "is_std", "extractor",
             "fvd_published_comparable", "is_classifier",
             "is_published_comparable", "frame_extractor",
             "fid_published_comparable"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread for the module's torch work and numpy's BLAS, restored
    after it: the suite runs six workers on the machine's cores, where a
    thread a core oversubscribes them (a 2 s CPU test took two minutes
    beside five busy workers; the CLI test's 2048-d Fréchet eighs three)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_mod, "MetricWriter", functools.partial(
        plogging.MetricWriter, use_tensorboard=False))


def make_trainer(out_dir, **kw) -> trainer_mod.Trainer:
    return trainer_mod.Trainer(Config(**{**KW, "out_dir": str(out_dir),
                                         **kw}))


def carry(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def port_of(ref_fx) -> features.I3DLikeFeatures:
    """A port I3DLikeFeatures holding the reference's weights."""
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    fx.params = {"blocks": [carry(b) for b in ref_fx.params["blocks"]]}
    return fx


class Frames:
    """A frame extractor from a clip extractor: (B, T, H, W, 3) ->
    (B·T, D), each frame a one-frame clip."""

    def __init__(self, fx):
        self.fx = fx

    def __call__(self, video):
        return self.fx(video.reshape(-1, 1, *video.shape[2:]))


class Counting:
    """A dataset that counts each item's reads."""

    def __init__(self, inner):
        self.inner, self.calls = inner, collections.Counter()

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        self.calls[i] += 1
        return self.inner[i]


def assert_rel(ours, ref, rel, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    gap = np.abs(ours - ref).max()
    assert gap <= rel * np.abs(ref).max(), (what, gap, np.abs(ref).max())


# ------------------------------------------------------------ bitwise maths
@pytest.mark.parametrize("n,d", [(24, 16), (6, 40)])
def test_frechet_and_inception_score_are_the_references_bitwise(n, d):
    rng = np.random.RandomState(n + d)
    a = rng.randn(n, d)
    b = rng.randn(n, d) * 1.3 + 0.2
    for x in (a, b):
        for ours, ref in zip(frechet.statistics(x), jfrechet.statistics(x)):
            np.testing.assert_array_equal(ours, ref)
    assert frechet.frechet_from_features(a, b) == \
        jfrechet.frechet_from_features(a, b)
    assert metrics.fvd(a, b) == jmetrics.fvd(a, b)
    assert metrics.fid(b, a) == jmetrics.fid(b, a)
    p = np.exp(rng.randn(n, d))
    p /= p.sum(axis=1, keepdims=True)
    assert metrics.inception_score(p) == jmetrics.inception_score(p)
    assert metrics.inception_score(p, 3) == jmetrics.inception_score(p, 3)
    with pytest.raises(ValueError, match=">= 2 feature rows"):
        frechet.statistics(a[:1])


def test_i3d_like_and_classifier_probs_match_reference():
    ref_fx = jfeatures.I3DLikeFeatures(seed=0, widths=WIDTHS)
    ref_clf = jfeatures.ClassifierProbs(3, seed=1, feature_extractor=ref_fx)
    fx = port_of(ref_fx)
    clf = features.ClassifierProbs(3, seed=1, feature_extractor=fx)
    clf.head = carry(ref_clf.head)
    v = np.random.RandomState(0).uniform(-1, 1, (3, 4, 32, 32, 3)).astype(
        np.float32)
    feats = fx(v)
    assert feats.dtype == np.float64 and feats.shape == (3, WIDTHS[-1])
    assert_rel(feats, ref_fx(v), 1e-4, "features")
    assert_rel(clf(v), ref_clf(v), 1e-4, "probs")
    # a torch tensor gives the numpy array's features
    np.testing.assert_array_equal(fx(torch.from_numpy(v)), feats)


# ------------------------------------------------------ evaluate_generator
def test_evaluate_generator_matches_reference_metrics(tmp_path):
    """fvd, fid and is_mean: the port's harness on its fakes vs the
    reference's extractors and metrics on the same clips (rtol 1e-4; the
    features differ by f32 summation order only)."""
    tr = make_trainer(tmp_path / "run")
    fakes = []
    sample = tr.sample

    def captured(*args, **kw):
        out = sample(*args, **kw)
        fakes.append(out.float().numpy())
        return out

    tr.sample = captured
    ref_fx = jfeatures.I3DLikeFeatures(seed=0, widths=WIDTHS)
    ref_clf = jfeatures.ClassifierProbs(3, seed=1, feature_extractor=ref_fx)
    fx = port_of(ref_fx)
    clf = features.ClassifierProbs(3, seed=1, feature_extractor=fx)
    clf.head = carry(ref_clf.head)
    out = metrics.evaluate_generator(tr, fx, n_samples=24, batch_size=8,
                                     classifier=clf,
                                     frame_extractor=Frames(fx))
    tr.close()
    assert set(out) == {"fvd", "fid", "is_mean", "is_std"}
    assert [f.shape for f in fakes] == [(8, 4, 32, 32, 3)] * 3
    fake = np.concatenate(fakes)
    rf, rff = jmetrics.compute_real_features(
        tr.dataset, ref_fx, 24, batch_size=8,
        frame_extractor=Frames(ref_fx))
    ref_f = jmetrics.extract_features(ref_fx, [fake])
    ref_ff = Frames(ref_fx)(fake)
    ref_is, _ = jmetrics.inception_score(ref_clf(fake))
    np.testing.assert_allclose(out["fvd"], jmetrics.fvd(rf, ref_f),
                               rtol=1e-4)
    np.testing.assert_allclose(out["fid"], jmetrics.fid(rff, ref_ff),
                               rtol=1e-4)
    np.testing.assert_allclose(out["is_mean"], ref_is, rtol=1e-4)
    assert out["fvd"] > 0 and 1.0 <= out["is_mean"] <= 3.0


def test_prediction_eval_scores_prefix_and_generated_frames(tmp_path):
    """DVD-GAN-FP: each real clip is read once and gives both its features
    and its fake's prefix; the fake the extractor sees is that prefix,
    then the frames G generated from it."""
    tr = make_trainer(tmp_path / "run", n_frames=6, cond_frames=2)
    ds = Counting(tr.dataset)
    tr.dataset = ds
    gens = []
    sample = tr.sample

    def captured(z, y, cond=None):
        out = sample(z, y, cond=cond)
        gens.append((out, y, cond))
        return out

    tr.sample = captured
    seen = []
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")

    def recording(video):
        seen.append(video)
        return fx(video)

    out = metrics.evaluate_generator(tr, recording, n_samples=4,
                                     batch_size=2)
    tr.close()
    assert np.isfinite(out["fvd"])
    assert sorted(ds.calls) == [0, 1, 2, 3]
    assert all(v == 1 for v in ds.calls.values())
    fakes = [v for v in seen if isinstance(v, torch.Tensor)]
    reals = [v for v in seen if isinstance(v, np.ndarray)]
    assert len(fakes) == len(reals) == len(gens) == 2
    for i, (fake, (gen, y, cond)) in enumerate(zip(fakes, gens)):
        items = [ds.inner[2 * i + j] for j in range(2)]
        clips = np.stack([c for c, _ in items])
        np.testing.assert_array_equal(reals[i], clips)
        assert fake.shape == (2, 6, 32, 32, 3) and gen.shape[1] == 4
        np.testing.assert_array_equal(fake[:, :2].numpy(), clips[:, :2])
        np.testing.assert_array_equal(cond.numpy(), clips[:, :2])
        np.testing.assert_array_equal(fake[:, 2:].numpy(), gen.numpy())
        assert y.tolist() == [lbl for _, lbl in items]


def test_real_features_cache_gives_the_same_value_without_reads(tmp_path):
    tr = make_trainer(tmp_path / "run")
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    base = metrics.evaluate_generator(tr, fx, n_samples=6, batch_size=3)
    rf = metrics.compute_real_features(tr.dataset, fx, 6, batch_size=3)
    ds = Counting(tr.dataset)
    tr.dataset = ds
    cached = metrics.evaluate_generator(tr, fx, n_samples=6, batch_size=3,
                                        real_features=rf)
    assert cached["fvd"] == base["fvd"] and not ds.calls
    with pytest.raises(ValueError, match="recompute the cache"):
        metrics.evaluate_generator(tr, fx, n_samples=6, batch_size=3,
                                   real_features=(np.zeros((3, 16)), None))
    with pytest.raises(ValueError, match="frame_extractor"):
        metrics.evaluate_generator(tr, fx, n_samples=6, batch_size=3,
                                   frame_extractor=fx,
                                   real_features=(np.zeros((6, 16)), None))
    tr.close()


def test_trainer_evaluate_keeps_its_real_side(tmp_path):
    tr = make_trainer(tmp_path / "run")
    ds = Counting(tr.dataset)
    tr.dataset = ds
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    a = tr.evaluate(extractor=fx, n_samples=6)
    first = sum(ds.calls.values())
    b = tr.evaluate(extractor=fx, n_samples=6)
    tr.close()
    assert first == 6 and sum(ds.calls.values()) == first
    assert a["fvd"] == b["fvd"]          # same EMA-G, same draws, same reals


def test_sample_seed_gives_another_fake_stream(tmp_path):
    tr = make_trainer(tmp_path / "run")
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    rf = metrics.compute_real_features(tr.dataset, fx, 6, batch_size=3)
    runs = [metrics.evaluate_generator(tr, fx, n_samples=6, batch_size=3,
                                       real_features=rf, sample_seed=s)
            for s in (1234, 2234, 1234)]
    tr.close()
    assert runs[0]["fvd"] != runs[1]["fvd"]
    assert runs[0]["fvd"] == runs[2]["fvd"]


# ------------------------------------------------------------- real stats
def test_real_stats_round_trip_and_stamps(tmp_path):
    tr = make_trainer(tmp_path / "run")
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    fx2d = Frames(fx)
    path = str(tmp_path / "real_stats")          # no .npz suffix: normalised
    meta = {"dataset": "synthetic", "n": 6, "extractor": "toy"}
    rf, rff = metrics.load_or_compute_real_stats(
        path, tr.dataset, fx, 6, batch_size=3, frame_extractor=fx2d,
        meta=meta)
    assert os.path.isfile(path) and not os.path.exists(path + ".tmp.npz")
    ds = Counting(tr.dataset)
    rf2, rff2 = metrics.load_or_compute_real_stats(
        path, ds, fx, 6, batch_size=3, frame_extractor=fx2d, meta=meta)
    assert not ds.calls
    np.testing.assert_array_equal(rf, rf2)
    np.testing.assert_array_equal(rff, rff2)
    ref = jmetrics.load_or_compute_real_stats(path, ds, fx, 6, meta=meta)
    np.testing.assert_array_equal(ref[0], rf)     # the reference reads it
    with pytest.raises(ValueError, match="real-stats n mismatch"):
        metrics.load_or_compute_real_stats(path, ds, fx, 6,
                                           meta={**meta, "n": 7})
    with pytest.raises(ValueError, match="cache has '<absent>'"):
        metrics.load_or_compute_real_stats(path, ds, fx, 6,
                                           meta={**meta, "extra": 1})
    tr.close()


def test_file_stamp_invalidates_real_stats(tmp_path):
    w = tmp_path / "w.npz"
    w.write_bytes(b"abc")
    stamp = metrics.file_stamp(str(w))
    assert stamp == jmetrics.file_stamp(str(w)) and stamp.startswith("w.npz:3:")
    assert metrics.file_stamp("") == "none"
    tr = make_trainer(tmp_path / "run")
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    path = str(tmp_path / "rs.npz")
    metrics.load_or_compute_real_stats(path, tr.dataset, fx, 4,
                                       meta={"extractor_weights": stamp})
    w.write_bytes(b"abcd")                        # the weights file changed
    with pytest.raises(ValueError, match="extractor_weights mismatch"):
        metrics.load_or_compute_real_stats(
            path, tr.dataset, fx, 4,
            meta={"extractor_weights": metrics.file_stamp(str(w))})
    tr.close()


def test_real_stats_write_false_touches_no_disk(tmp_path):
    tr = make_trainer(tmp_path / "run")
    fx = features.I3DLikeFeatures(widths=WIDTHS, device="cpu")
    d = tmp_path / "stats"
    d.mkdir()
    rf, rff = metrics.load_or_compute_real_stats(
        str(d / "rs.npz"), tr.dataset, fx, 4, write=False)
    tr.close()
    assert rf.shape == (4, WIDTHS[-1]) and rff is None
    assert not os.listdir(d)


# ------------------------------------------------------------ in training
def run_steps(out_dir, evaluate: bool, k: int):
    tr = make_trainer(out_dir, total_step=4, ema_start=0, steps_per_call=k,
                      eval_step=2 if evaluate else 0, eval_samples=4)
    if evaluate:                 # I3D at the clip's own 32², not at 224²
        tr._eval_fx = features.I3DFeatures(resize=None, device="cpu")
        tr._eval_clf = features.I3DClassifierProbs(
            feature_extractor=tr._eval_fx)
    tr.train()
    tr.close()
    return interop.train_state_to_flat(tr.state)


@pytest.mark.parametrize("k", [1, 2])
def test_eval_step_leaves_the_runs_bits(k, tmp_path, capsys):
    plain = run_steps(tmp_path / "a", False, k)
    evaluated = run_steps(tmp_path / "b", True, k)
    assert plain.keys() == evaluated.keys()
    for name, v in plain.items():
        np.testing.assert_array_equal(v, evaluated[name], err_msg=name)
    with open(tmp_path / "b" / "logs" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    fvd = {r["step"]: r["value"] for r in rows if r["tag"] == "fvd"}
    assert sorted(fvd) == [2, 4] and all(np.isfinite(list(fvd.values())))
    assert {r["tag"] for r in rows if r["step"] == 4} >= {"fvd", "is_mean",
                                                          "is_std"}
    printed = capsys.readouterr().out
    assert "eval @ 2: fvd " in printed and "eval @ 4: fvd " in printed


# -------------------------------------------------------------------- CLI
def test_eval_cli_prints_the_references_keys(tmp_path, monkeypatch, capsys):
    """In process on the CPU, with I3D at the clips' own 32² and
    Inception-v3 at 75² giving its 1000 logits (the sizes of this test, not
    the protocol's: a 2048-d FID's eighs take seconds on one thread): the
    JSON line, the --real_stats cache read back to the same fvd, and
    --eval_repeats' *_std keys."""
    monkeypatch.setattr(cli, "I3DFeatures", functools.partial(
        features.I3DFeatures, resize=None))
    monkeypatch.setattr(cli, "InceptionFeatures", functools.partial(
        features.InceptionFeatures, resize=75, feature="logits"))
    flags = ["--mode", "eval", "--device", "cpu", "--dataset", "synthetic",
             "--n_classes", "3", "--img_size", "32", "--n_frames", "4",
             "--ch", "8", "--d_ch", "8", "--k_frames", "2", "--bf16", "0",
             "--batch_size", "2", "--n_samples", "4",
             "--out_dir", str(tmp_path / "run")]
    stats = str(tmp_path / "real.npz")

    def run(*extra):
        out = cli.main(flags + list(extra))
        lines = capsys.readouterr().out.strip().splitlines()
        assert json.loads(lines[-1]) == out
        return out, lines

    first, lines = run("--real_stats", stats)
    assert set(first) == EVAL_KEYS
    assert first["extractor"] == first["is_classifier"] == "i3d-random-init"
    assert first["frame_extractor"] == "inception-v3-random-init"
    assert not any(first[k] for k in ("fvd_published_comparable",
                                      "is_published_comparable",
                                      "fid_published_comparable"))
    assert all(np.isfinite(first[k]) and first[k] >= 0
               for k in ("fvd", "fid"))
    assert 1.0 <= first["is_mean"] <= 400.0
    launches = json.loads(next(x for x in lines
                               if x.startswith("eval_launches "))[14:])
    assert launches["k1"] == 0         # the CPU runs K1's plain version
    assert os.path.isfile(stats)
    again, _ = run("--real_stats", stats)
    assert again["fvd"] == first["fvd"] and again["fid"] == first["fid"]
    repeated, _ = run("--eval_repeats", "2")
    assert set(repeated) == EVAL_KEYS | {"fvd_std", "fid_std",
                                         "is_mean_std", "eval_repeats"}
    assert repeated["eval_repeats"] == 2
