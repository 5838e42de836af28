"""Evaluation: FVD, video IS and frame FID with pluggable feature
extractors — the counterpart of `dvdgan_tpu/eval/`."""

from dvdgan_tpu_torch.eval import c3d, i3d, inception  # noqa: F401
from dvdgan_tpu_torch.eval.features import (  # noqa: F401
    C3DClassifierProbs, C3DFeatures, ClassifierProbs, I3DClassifierProbs,
    I3DFeatures, I3DLikeFeatures, InceptionFeatures)
from dvdgan_tpu_torch.eval.frechet import (  # noqa: F401
    frechet_distance, frechet_from_features, statistics)
from dvdgan_tpu_torch.eval.metrics import (  # noqa: F401
    compute_real_features, evaluate_generator, extract_features, fid,
    file_stamp, fvd, inception_score, load_or_compute_real_stats)
