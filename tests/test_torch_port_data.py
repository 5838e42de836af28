"""The port's own input pipeline against the reference's, and the port's
import hygiene.

`dvdgan_tpu_torch.data` is a numpy-only copy of `dvdgan_tpu.data`'s
synthetic dataset and loader: the same seed gives the same clips, labels
and batch order, bitwise. The port imports torch and never jax, and nothing
of the `dvdgan_tpu` package: every `.py` under `dvdgan_tpu_torch/` and
`chip_smoke.py` is parsed and its import statements are checked.
"""

from __future__ import annotations

import ast
import itertools
import os

import numpy as np
import pytest

from dvdgan_tpu.data import loader as jloader
from dvdgan_tpu.data import synthetic as jsynthetic
from dvdgan_tpu_torch import data
from dvdgan_tpu_torch.data import loader, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS_KW = dict(n_items=12, n_frames=4, img_size=16, n_classes=5, seed=3)


def port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tools", f"{name}.py")
        for name in ("torch_export_serving", "torch_bench_sample")]
    for root, _, files in os.walk(os.path.join(REPO, "dvdgan_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    paths = port_sources()
    assert len(paths) > 30 and all(os.path.isfile(p) for p in paths)
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "dvdgan_tpu")]
    assert not bad, bad


def test_synthetic_clips_and_labels_match_reference():
    ours = synthetic.SyntheticVideoDataset(**DS_KW)
    ref = jsynthetic.SyntheticVideoDataset(**DS_KW)
    assert len(ours) == len(ref) == DS_KW["n_items"]
    for i in range(len(ref)):
        clip, label = ours[i]
        ref_clip, ref_label = ref[i]
        assert clip.dtype == ref_clip.dtype and clip.shape == ref_clip.shape
        np.testing.assert_array_equal(clip, ref_clip)
        assert label == ref_label
    np.testing.assert_array_equal(
        synthetic.make_clip(7, 2, 5, 16, 5), jsynthetic.make_clip(7, 2, 5, 16, 5))


@pytest.mark.parametrize("shuffle,num_threads", [(True, 1), (True, 2),
                                                 (False, 1)])
def test_loader_batches_match_reference(shuffle, num_threads):
    """Two epochs and a resumed position: the same batches in the same
    order as the reference's loader for the same seed."""
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, num_threads=num_threads)
    ours = loader.Loader(synthetic.SyntheticVideoDataset(**DS_KW), **kw)
    ref = jloader.Loader(jsynthetic.SyntheticVideoDataset(**DS_KW), **kw)
    assert ours.batches_per_epoch() == ref.batches_per_epoch() == 3
    its = ours.forever(0, 0), ref.forever(0, 0)
    try:
        for (clips, labels), (ref_clips, ref_labels) in itertools.islice(
                zip(*its), 6):
            assert clips.dtype == np.float32 and labels.dtype == np.int32
            np.testing.assert_array_equal(clips, ref_clips)
            np.testing.assert_array_equal(labels, ref_labels)
    finally:
        for it in its:
            it.close()
    its = ours.forever(1, 2), ref.forever(1, 2)     # epoch 1, batch 2
    try:
        (clips, labels), (ref_clips, ref_labels) = next(its[0]), next(its[1])
        np.testing.assert_array_equal(clips, ref_clips)
        np.testing.assert_array_equal(labels, ref_labels)
    finally:
        for it in its:
            it.close()
    ours.close()
    ref.close()


def test_data_package_exports():
    assert data.Loader is loader.Loader
    assert data.SyntheticVideoDataset is synthetic.SyntheticVideoDataset
