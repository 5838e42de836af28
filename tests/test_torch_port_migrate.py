"""The port's migration to and from PyTorch state dicts
(`dvdgan_tpu_torch/migrate.py`, `tools/torch_import_checkpoint.py`,
`tools/torch_export_checkpoint.py`) against dvdgan_tpu's
`tools/import_torch_checkpoint.py` and `tools/export_torch_checkpoint.py`.

At the repo's test scale (img 32, T 4, ch 8), f32, on one torch thread:

  * `from_port` of a state carried from the reference's
    `train_state.create` (through `interop`, every leaf moved off its
    init) equals the reference's `export_state` key for key and bitwise,
    with attention, without it and for DVD-GAN-FP, and loads with
    strict=True into the twin's modules;
  * `to_port` of twin state dicts equals the reference's `convert`
    through the flat paths, bitwise, from .pth, .npz, a {"state_dict"}
    container, spectral-norm wrapper keys and bf16 tensors;
  * from the reference's fresh SN u (carried through `interop`), the u
    `build_state` warms up equals the reference's within 1e-6, and σ
    within 1e-6 relative;
  * a missing, extra or misshaped key, and a port leaf with no place in
    the naming, raise and name it;
  * the export CLI then the import CLI give back params, stats and EMA
    bitwise, at the step;
  * end to end: the import CLI's checkpoint resumes in the `Trainer`
    through --pretrained_model, and `step.sample` of it equals the
    source's at atol 0.
"""

from __future__ import annotations

import ast
import os
import re

import numpy as np
import pytest

import jax
import torch

from dvdgan_tpu.core import tree as jtree
from dvdgan_tpu.ops import spectral_norm as jsn
from dvdgan_tpu.train import state as jstate
from dvdgan_tpu.utils import config as jconfig
from dvdgan_tpu_torch import interop, migrate
from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.train import checkpoint
from dvdgan_tpu_torch.train import step as step_mod
from dvdgan_tpu_torch.train import trainer as trainer_mod
from dvdgan_tpu_torch.utils import config as config_mod
from tools import export_torch_checkpoint as jexp
from tools import import_torch_checkpoint as jimp
from tools import torch_export_checkpoint as port_exp
from tools import torch_import_checkpoint as port_imp
from tools import torch_twin as tw

FLAGS = ["--img_size", "32", "--n_frames", "4", "--ch", "8", "--d_ch", "8",
         "--k_frames", "2", "--z_dim", "12", "--emb_dim", "8",
         "--n_classes", "5", "--batch_size", "2", "--bf16", "0",
         "--seed", "0"]
CASES = {"attn": ["--attn_res", "16"],
         "no_attn": ["--attn_res", "64"],     # past img_size: no attention
         "fp": ["--attn_res", "16", "--cond_frames", "2"]}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread for torch and numpy's BLAS, restored after the module
    (`test_torch_port_eval.py`: the suite's workers share the cores)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def test_migration_imports_torch_numpy_and_the_port_only():
    """`migrate.py` and both CLIs run where jax is not installed: they
    import nothing of jax, of `dvdgan_tpu` or of `tools/`."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bad = []
    for rel in ("dvdgan_tpu_torch/migrate.py",
                "tools/torch_import_checkpoint.py",
                "tools/torch_export_checkpoint.py"):
        with open(os.path.join(repo, rel)) as f:
            tree = ast.parse(f.read(), rel)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [f"{rel}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "dvdgan_tpu",
                                           "tools")]
    assert not bad, bad


def configs(flags):
    """(reference Config, port Config) of the same flags."""
    return jconfig.parse_config(flags), config_mod.parse_config(flags)


def reference_flat(jcfg, seed: int) -> dict[str, np.ndarray]:
    """The reference's `train_state.create` flattened its way, each float
    leaf of the models, the EMA and G's BN stats moved off its init (the
    init's stats, EMA and biases are constants)."""
    st = jstate.create(jax.random.PRNGKey(seed), jcfg.g_config(),
                       jcfg.ds_config(), jcfg.dt_config(),
                       jcfg.train_config())
    flat = {k: np.asarray(v) for k, v in jtree.flatten_with_paths(st).items()}
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        noise = np.asarray(rng.randn(*v.shape), np.float32)
        if k.startswith("g/stats/") and k.endswith("/var"):
            flat[k] = (v + np.abs(noise)).astype(np.float32)
        elif k.startswith(("g/params/", "ds/params/", "dt/params/", "g_ema/",
                           "g/stats/")):
            flat[k] = (v + np.float32(0.05) * noise).astype(np.float32)
    return flat


def twin_state_dicts(jcfg, seed: int) -> dict[str, dict]:
    """{G, DS, DT}: the twin's modules at torch's own init (distinct
    singular values, non-zero biases) with random BN running stats."""
    torch.manual_seed(seed)
    mods = {"G": tw.Generator(jcfg.g_config()),
            "DS": tw.SpatialDiscriminator(jcfg.ds_config()),
            "DT": tw.TemporalDiscriminator(jcfg.dt_config())}
    for m in mods["G"].modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
            m.num_batches_tracked.fill_(17)
    for p in mods["G"].attn.parameters() if mods["G"].attn else ():
        if p.dim() == 0:
            p.data.fill_(0.3)
    return {k: m.state_dict() for k, m in mods.items()}


def assert_flat_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.float32 and g.shape == np.shape(v), k
        assert np.array_equal(g, np.asarray(v, np.float32)), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_port_equals_the_reference_export(case, tmp_path):
    jcfg, cfg = configs(FLAGS + CASES[case])
    flat = reference_flat(jcfg, seed=1)
    state = interop.load_train_state(flat)
    ours = migrate.from_port(state, cfg.g_config(), cfg.ds_config(),
                             cfg.dt_config())
    assert sorted(ours) == sorted(migrate.MODELS)
    jexp.export_state(tru.unflatten(flat), jcfg.g_config(), jcfg.ds_config(),
                      jcfg.dt_config(), str(tmp_path))
    for name, sd in ours.items():
        ref = torch.load(str(tmp_path / f"{name}.pth"), weights_only=True)
        assert list(sd) and sd.keys() == ref.keys(), (
            name, sorted(sd.keys() ^ ref.keys()))
        for k, v in ref.items():
            assert sd[k].dtype == v.dtype and sd[k].is_contiguous(), (name, k)
            assert torch.equal(sd[k], v), (name, k)
    if case == "fp":
        assert any(k.startswith("fp_enc.") for k in ours["G"])
    assert any(k.startswith("attn.") for k in ours["G"]) == (
        case != "no_attn")
    tw.Generator(jcfg.g_config()).load_state_dict(ours["G_ema"], strict=True)
    tw.TemporalDiscriminator(jcfg.dt_config()).load_state_dict(
        ours["DT"], strict=True)


def _write(sd: dict, fmt: str, path: str) -> str:
    if fmt == "npz":
        np.savez(path + ".npz", **{k: v.numpy() for k, v in sd.items()})
        return path + ".npz"
    if fmt == "container":
        sd = {"state_dict": sd, "epoch": 3}
    elif fmt == "sn_wrapped":       # torch.nn.utils.spectral_norm's keys
        out = {}
        for k, v in sd.items():
            if k.endswith(".weight") and v.dim() >= 2:
                out[k + "_orig"] = v
                out[k[:-len("weight")] + "weight_u"] = torch.randn(v.shape[0])
                out[k[:-len("weight")] + "weight_v"] = torch.randn(3)
            else:
                out[k] = v
        sd = out
    elif fmt == "bf16":
        sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in sd.items()}
    torch.save(sd, path + ".pth")
    return path + ".pth"


@pytest.mark.parametrize("fmt", ["pth", "npz", "container", "sn_wrapped",
                                 "bf16"])
def test_to_port_equals_the_reference_convert(fmt, tmp_path):
    jcfg, cfg = configs(FLAGS + CASES["attn"])
    sds = twin_state_dicts(jcfg, seed=2)
    paths = {k: _write(sd, fmt, str(tmp_path / k)) for k, sd in sds.items()}
    ref = jimp.convert(*(jimp._load_state_dict(paths[k])
                         for k in ("G", "DS", "DT")),
                       jcfg.g_config(), jcfg.ds_config(), jcfg.dt_config())
    ours = migrate.to_port(*(migrate.load_state_dict(paths[k])
                             for k in ("G", "DS", "DT")),
                           cfg.g_config(), cfg.ds_config(), cfg.dt_config())
    for got, want in zip(ours, ref):
        assert_flat_equal(tru.flatten_with_paths(got),
                          jtree.flatten_with_paths(want))


def test_sn_warmup_matches_the_reference():
    """From the reference's fresh u, carried across, 30 power iterations
    against the imported weights (torch's init: distinct singular values)
    give the reference's u within 1e-6 and σ within 1e-6 relative."""
    jcfg, cfg = configs(FLAGS + CASES["attn"])
    sds = twin_state_dicts(jcfg, seed=3)
    trees = migrate.to_port(sds["G"], sds["DS"], sds["DT"], cfg.g_config(),
                            cfg.ds_config(), cfg.dt_config())
    ref = jimp.build_state(jcfg, *jimp.convert(
        sds["G"], sds["DS"], sds["DT"], jcfg.g_config(), jcfg.ds_config(),
        jcfg.dt_config()), step=5, sn_warmup=30, seed=0)
    fresh = interop.load_train_state(reference_flat(jcfg, seed=0))
    ours = migrate.build_state(cfg, *trees, step=5, sn_warmup=30,
                               sn_u={m: fresh[m]["sn_u"]
                                     for m in ("g", "ds", "dt")})
    assert int(ours["step"]) == 5 and ours["step"].dtype == torch.int32
    for m in ("g", "ds", "dt"):
        ref_u = {k: np.asarray(v) for k, v in ref[m]["sn_u"].items()}
        assert ours[m]["sn_u"].keys() == ref_u.keys()
        for k, u in ours[m]["sn_u"].items():
            np.testing.assert_allclose(u.numpy(), ref_u[k], rtol=0,
                                       atol=1e-6, err_msg=f"{m} {k}")
        ref_s = jsn.sn_sigmas(ref[m]["params"], ref[m]["sn_u"])
        for k, s in sn.sn_sigmas(ours[m]["params"], ours[m]["sn_u"]).items():
            np.testing.assert_allclose(float(s), float(ref_s[k]), rtol=1e-6,
                                       err_msg=f"{m} {k}")
        assert int(ours[m]["opt"]["count"]) == 0
        assert all(not v.any() for v in
                   tru.flatten_with_paths(ours[m]["opt"]["mu"]).values())
    assert_flat_equal(tru.flatten_with_paths(ours["g_ema"]),
                      tru.flatten_with_paths(trees[0]))


def _tree_with(tree, path: str, leaf) -> dict:
    flat = dict(tru.flatten_with_paths(tree))
    flat[path] = leaf
    return tru.unflatten(flat)


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped",
                                   "gru_h_bias", "unknown_leaf",
                                   "state_leaf"])
def test_a_key_off_the_naming_raises_and_names_it(fault):
    _, cfg = configs(FLAGS + CASES["attn"])
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    state = interop.load_train_state(reference_flat(configs(
        FLAGS + CASES["attn"])[0], seed=4))
    sds = migrate.from_port(state, g_cfg, ds_cfg, dt_cfg)
    g, ds, dt = sds["G"], dict(sds["DS"]), dict(sds["DT"])
    g_params = state["g"]["params"]
    if fault == "missing":
        name = "blocks.1.conv2.weight"
        del ds[name]
        call = lambda: migrate.to_port(g, ds, dt, g_cfg, ds_cfg, dt_cfg)
    elif fault == "extra":
        name = "blocks.0.conv1.scale"
        dt[name] = torch.zeros(3)
        call = lambda: migrate.to_port(g, ds, dt, g_cfg, ds_cfg, dt_cfg)
    elif fault == "misshaped":
        name = "grus.1.cand.weight"
        g = dict(g, **{name: g[name][:, :-1]})
        call = lambda: migrate.to_port(g, ds, dt, g_cfg, ds_cfg, dt_cfg)
    elif fault == "gru_h_bias":     # the twin puts no bias on the h halves
        name = "levels/0/gru/gates_h/b"
        tree = _tree_with(g_params, name, torch.zeros(16))
        call = lambda: migrate.key_map("G", tree, state["g"]["stats"])
    elif fault == "unknown_leaf":
        name = "out_conv/w_scale"
        tree = _tree_with(g_params, name, torch.zeros(3))
        call = lambda: migrate.key_map("G", tree, state["g"]["stats"])
    else:
        name = "head/psi/b2"
        bad = dict(state, dt=dict(state["dt"], params=_tree_with(
            state["dt"]["params"], name, torch.zeros(2))))
        call = lambda: migrate.from_port(bad, g_cfg, ds_cfg, dt_cfg)
    with pytest.raises((KeyError, ValueError), match=re.escape(name)):
        call()


def test_export_then_import_cli_is_bitwise(tmp_path):
    """A port checkpoint through `tools/torch_export_checkpoint.py`, then
    `tools/torch_import_checkpoint.py` with G_ema: params, G's stats and
    the EMA bitwise, the step kept."""
    jcfg, _ = configs(FLAGS + CASES["fp"])
    state = interop.load_train_state(reference_flat(jcfg, seed=5))
    flags = FLAGS + CASES["fp"]
    src = str(tmp_path / "src")
    checkpoint.save(os.path.join(src, "checkpoints"), 3, state)
    exp = str(tmp_path / "exported")
    written = port_exp.main(flags + ["--out_dir", src, "--export_dir", exp])
    assert sorted(os.path.basename(p) for p in written) == [
        "DS.pth", "DT.pth", "G.pth", "G_ema.pth"]
    files = {"g": "G", "g_ema": "G_ema", "ds": "DS", "dt": "DT"}
    ckpt_dir = port_imp.main(flags + [
        "--out_dir", str(tmp_path / "dst"), "--step", "3", "--sn_warmup",
        "2", *(a for k, f in files.items()
               for a in (f"--{k}_ckpt", os.path.join(exp, f"{f}.pth")))])
    back = interop.load_train_state_npz(
        os.path.join(ckpt_dir, "3", checkpoint.STATE_FILE))
    assert int(back["step"]) == 3
    for tree in (lambda s: s["g"]["params"], lambda s: s["g"]["stats"],
                 lambda s: s["g_ema"], lambda s: s["ds"]["params"],
                 lambda s: s["dt"]["params"]):
        assert_flat_equal(tru.flatten_with_paths(tree(back)),
                          tru.flatten_with_paths(tree(state)))


def test_imported_checkpoint_resumes_and_samples_as_the_source(tmp_path):
    """The import CLI on the state dicts the reference's `export_state`
    writes of a carried state, then the Trainer resuming it through
    --pretrained_model: the step, the weights, one more step with finite
    losses, and `step.sample` of the imported state equal to the source's
    at atol 0."""
    flags = FLAGS + CASES["attn"]
    jcfg, _ = configs(flags)
    flat = reference_flat(jcfg, seed=6)
    state = interop.load_train_state(flat)
    exp = str(tmp_path / "torch")
    jexp.export_state(tru.unflatten(flat), jcfg.g_config(), jcfg.ds_config(),
                      jcfg.dt_config(), exp)
    out_dir = str(tmp_path / "run")
    port_imp.main(flags + ["--out_dir", out_dir, "--step", "7",
                           "--g_ckpt", os.path.join(exp, "G.pth"),
                           "--ds_ckpt", os.path.join(exp, "DS.pth"),
                           "--dt_ckpt", os.path.join(exp, "DT.pth")])
    cfg = config_mod.parse_config(flags + [
        "--device", "cpu", "--out_dir", out_dir, "--pretrained_model", "7",
        "--total_step", "8", "--log_step", "1", "--sample_step", "0",
        "--model_save_step", "0", "--dataset", "synthetic"])
    tr = trainer_mod.Trainer(cfg)
    try:
        assert tr.start_step == 7
        assert_flat_equal(tru.flatten_with_paths(tr.state["g"]["params"]),
                          tru.flatten_with_paths(state["g"]["params"]))
        gen = torch.Generator().manual_seed(0)
        z = torch.randn(2, cfg.g_config().z_dim, generator=gen)
        y = torch.tensor([1, 3])
        g_cfg = cfg.g_config()
        ours = step_mod.sample(tr.state["g_ema"], tr.state["g"]["stats"],
                               tr.state["g"]["sn_u"], z, y, g_cfg)
        # the source's weights with the imported state's u: sampling reads
        # u (one frozen iteration), and the import converges fresh ones
        want = step_mod.sample(state["g"]["params"], state["g"]["stats"],
                               tr.state["g"]["sn_u"], z, y, g_cfg)
        assert torch.equal(ours, want)
        metrics = tr.train()
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        assert tr.start_step == 8
    finally:
        tr.close()
