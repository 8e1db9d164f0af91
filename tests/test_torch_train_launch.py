"""The port's training launcher, its compress launcher's checkpoint flags
and the gradient quantizer against the JAX package's, on the CPU, across
the two packages' checkpoints.

Tolerances:
- the quantizer: bit for bit (``_quantize`` rounds half to even in both).
- the launchers: the port resumed from a JAX-written step-2 checkpoint runs
  steps 3-5 (lr 3e-3, AdamW eps 1e-8); its step-5 leaves are within 1e-5 of
  JAX's step 5 plus 1e-5 of the leaf's largest entry. AdamW's update
  m / (sqrt(v) + eps) stays smooth in the gradient here, since the restored
  moments are equal and far from 0, so the fp32 rounding of the two
  backwards moves a leaf by about lr x 1e-6 a step. The port resumed equals
  the port uninterrupted bit for bit. The compress launcher on one
  checkpoint: base CE at rtol 1e-5 (the same fp32 forward), compressed CE at
  rtol 1e-4 (SVDs of the two packages).
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.ckpt.checkpoint import _flatten_with_paths
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.train import grad_compress as jgc
from repro_torch import convert
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_to_numpy
from repro_torch.launch import compress as launch_compress
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train import grad_compress as tgc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARGS = ["--arch", "smollm_135m", "--smoke", "--steps", "6",
              "--ckpt-every", "2", "--seq", "32", "--batch", "4"]


def _flat(tree):
    paths, leaves, _ = _flatten_with_paths(tree)
    return dict(zip(paths, (np.asarray(x) for x in leaves)))


def _assert_flat_bits(got, want):
    assert list(got) == list(want)
    for p, w in want.items():
        g = got[p]
        if w.dtype.name == "bfloat16":
            assert g.dtype == convert.BF16_BITS, p
            np.testing.assert_array_equal(g.view(np.uint16), w.view(np.uint16),
                                          err_msg=p)
        else:
            assert g.dtype == w.dtype, p
            np.testing.assert_array_equal(g, w, err_msg=p)


# ---------------------------------------------------------------------------
# gradient quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (4, 128), (7, 33), (1,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_matches_jax(shape, dtype):
    x = np.random.RandomState(sum(shape)).standard_normal(shape).astype(
        np.float32) * 3
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jgc._quantize(jx)
    tq, ts = tgc._quantize(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    deq = tgc._dequantize(tq, ts, shape)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jgc._dequantize(jq, js, shape)))
    rt = tgc.simulate_roundtrip(tx)
    assert rt.dtype == tx.dtype
    np.testing.assert_array_equal(rt.float().numpy(), np.asarray(
        jgc.simulate_roundtrip(jx).astype(jnp.float32)))


def test_error_feedback_telescopes():
    """Port of tests/test_train.py's test: accumulated error-feedback
    updates converge to the true sum; the residual is the last step's
    quantization error, not an accumulation."""
    gen = torch.Generator().manual_seed(1)
    true_sum, applied, err = (torch.zeros(512) for _ in range(3))
    for _ in range(50):
        g = torch.randn(512, generator=gen) * 0.1
        true_sum = true_sum + g
        target = g + err
        q = tgc.simulate_roundtrip(target)
        err = target - q
        applied = applied + q
    resid = float(torch.linalg.norm(true_sum - applied))
    np.testing.assert_allclose(resid, float(torch.linalg.norm(err)), rtol=1e-4)
    assert resid < 0.05 * float(torch.linalg.norm(true_sum))
    rt = tgc.simulate_roundtrip(torch.randn(1000, generator=gen))
    state = tgc.init_error_state({"a": torch.ones(3, 4)}, 2)
    assert state["a"].shape == (2, 3, 4) and state["a"].dtype == torch.float32
    assert rt.shape == (1000,)


# ---------------------------------------------------------------------------
# the launchers across the packages
# ---------------------------------------------------------------------------

class _JaxTokens:
    """The JAX ``TokenPipeline``'s batches as CPU tensors, in the port
    pipeline's place: torch's RNG cannot give jax.random's tokens, so a run
    held against the JAX launcher's is fed its data."""

    def __init__(self, dcfg, model_cfg=None, *, device="cpu"):
        self.pipe = JTokenPipeline(JDataConfig(**vars(dcfg)))

    def get_batch(self, step):
        return {k: torch.from_numpy(np.asarray(v))
                for k, v in self.pipe.get_batch(step).items()}


def _jax(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-m", module] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=cwd)


def _done(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def _keep_up_to(src, dst, last):
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if name.startswith("step_") and int(name[5:]) > last:
            shutil.rmtree(os.path.join(dst, name))


def _leaves(d, step):
    path = os.path.join(d, f"step_{step}")
    meta = json.load(open(os.path.join(path, "manifest.json")))
    return {p: np.load(os.path.join(path, f"leaf_{i}.npy"))
            for i, p in enumerate(meta["paths"])}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """JAX's train launcher writes steps 2, 4, 5; the port runs
    uninterrupted and again resumed from its own step 2; then, fed JAX's
    tokens, it resumes from a copy of JAX's directory cut to step 2, and its
    compress launcher restores JAX's step 5, as JAX's does (in the
    background meanwhile)."""
    d = tmp_path_factory.mktemp("launch")
    jax_dir = str(d / "jax")
    _done(_jax("repro.launch.train", TRAIN_ARGS + ["--ckpt-dir", jax_dir], d))
    jcomp = _jax("repro.launch.compress", ["--arch", "smollm_135m", "--smoke",
                                           "--ckpt-in", jax_dir], d)
    out = {"jax_dir": jax_dir, "dir": d}

    def run(key, main, args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[key] = main(args)
        out[key + "_stdout"] = buf.getvalue()

    run("whole", launch_train.main,
        TRAIN_ARGS + ["--ckpt-dir", str(d / "whole"), "--device", "cpu"])
    _keep_up_to(d / "whole", d / "again", 2)
    run("again", launch_train.main,
        TRAIN_ARGS + ["--ckpt-dir", str(d / "again"), "--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch_train, "TokenPipeline", _JaxTokens)
        mp.setattr(launch_compress, "TokenPipeline", _JaxTokens)
        _keep_up_to(jax_dir, d / "resumed", 2)
        run("resumed", launch_train.main,
            TRAIN_ARGS + ["--ckpt-dir", str(d / "resumed"), "--device", "cpu"])
        run("compress", launch_compress.main, [
            "--arch", "smollm_135m", "--smoke", "--device", "cpu",
            "--ckpt-in", jax_dir, "--ckpt-out", str(d / "compressed"),
            "--numerics-report", "--trace-out", str(d / "trace.json")])
    text = _done(jcomp)
    out["jax_compress"] = json.loads(text[text.index("{"):text.rindex("}") + 1])
    return out


def test_train_launcher_resumes_from_a_jax_checkpoint(launched):
    res = launched["resumed"]
    assert "[resume] step 2" in launched["resumed_stdout"]
    assert res["start"] == 3 and len(res["step_seconds"]) == 3
    assert res["ckpt_steps"] == [2, 4, 5]
    assert [(s["step"], s["blocking"]) for s in res["saves"]] == \
        [(4, False), (5, True)]
    assert all(s["write_seconds"] > 0 for s in res["saves"])
    assert set(res["metrics"]) >= {"ce", "aux", "loss", "grad_norm", "lr"}
    got = _leaves(str(launched["dir"] / "resumed"), 5)
    want = _leaves(launched["jax_dir"], 5)
    assert list(got) == list(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == 6
    for p, w in want.items():
        assert got[p].dtype == w.dtype, p
        np.testing.assert_allclose(got[p], w, rtol=0,
                                   atol=1e-5 + 1e-5 * np.abs(w).max(), err_msg=p)


def test_train_launcher_resumes_itself_bit_for_bit(launched):
    assert launched["whole"]["start"] == 0 and launched["again"]["start"] == 3
    got = _leaves(str(launched["dir"] / "again"), 5)
    want = _leaves(str(launched["dir"] / "whole"), 5)
    assert list(got) == list(want)
    for p, w in want.items():
        np.testing.assert_array_equal(got[p], w, err_msg=p)
    assert launched["again"]["metrics"] == launched["whole"]["metrics"]


def test_compress_launcher_from_a_checkpoint_matches_jax(launched, capsys):
    res, want = launched["compress"], launched["jax_compress"]
    s = res["summary"]
    assert res["ckpt_step"] == 5 and res["seconds"]["pretrain"] == 0.0
    np.testing.assert_allclose(s["base_ce"], want["base_ce"], rtol=1e-5)
    np.testing.assert_allclose(s["compressed_ce"], want["compressed_ce"],
                               rtol=1e-4)
    assert s["layers"] == want["layers"]
    assert s["params_after"] == want["params_after"]


def test_compress_launcher_checkpoint_out_restores_in_both(launched):
    cmodel = launched["compress"]["compressed"]
    d = str(launched["dir"] / "compressed")
    want = convert.state_to_flat({"params": cmodel})
    like = {"params": jax.tree.map(jnp.zeros_like, params_to_numpy(cmodel))}
    restored, meta = JManager(d).restore(like)
    assert meta["step"] == 0
    _assert_flat_bits(want, _flat(restored))
    fresh = build_model(get_smoke_config("smollm_135m"), device="cpu")
    for name, mod in cmodel.named_modules():
        if getattr(mod, "is_factored", False):
            fresh.get_submodule(name).set_factors(torch.zeros_like(mod.b_t),
                                                  torch.zeros_like(mod.a_t))
    CheckpointManager(d).restore({"params": fresh})
    _assert_flat_bits(convert.state_to_flat({"params": fresh}), _flat(restored))


def test_compress_launcher_report_and_trace(launched):
    """``--numerics-report`` prints both of the reference's tables,
    ``--trace-out`` writes the ``ckpt.*`` spans beside calibration's."""
    text = launched["compress_stdout"]
    assert "restored step 5 from" in text and "saved to" in text
    i = text.index("# calibration numerics")
    j = text.index("# projection residual vs attainable bound")
    assert i < j < text.index('"base_ce"')
    assert "cond(R)" in text[i:j] and "resid/bound" in text[j:]
    trace = json.load(open(launched["dir"] / "trace.json"))
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"ckpt.restore", "ckpt.save", "calib.record"} <= names
    n = sum(e["ph"] != "M" for e in trace["traceEvents"])
    assert f"wrote {n} trace events" in text


REFUSED_MESHES = [
    (["--mesh", "1,1,2"], "a model axis of 2"),
    (["--mesh", "2,2,2", "--grad-compress"], "a model axis of 2"),
    (["--arch", "deepseek_moe_16b", "--mesh", "1,2,1"], "an MoE layer on a mesh"),
    (["--arch", "jamba_v0_1_52b", "--mesh", "2,1,1", "--grad-compress"],
     "an MoE layer on a mesh"),
]


def test_train_launcher_refuses_a_mesh(capsys):
    """What the pod and data axes do not cover still exits with an error
    naming ROADMAP item 13b-2, before any rank starts."""
    for extra, message in REFUSED_MESHES:
        with pytest.raises(SystemExit) as e:
            launch_train.main(["--smoke", "--device", "cpu", "--steps", "1"] + extra)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert message in err and "ROADMAP Queue 1, item 13b-2" in err, err


@pytest.mark.parametrize("extra, message", [
    (["--mesh", "2,1"], "expected pod,data,model sizes"),
    (["--mesh", "1,2,1", "--coordinator", "127.0.0.1:1", "--num-processes", "3"],
     "--num-processes 3 must equal the mesh's 2 ranks"),
    (["--mesh", "1,2,1", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "--process-id 2 not in 0..1"),
    (["--num-processes", "2"], "--num-processes and --process-id need --coordinator"),
    (["--mesh", "1,2,1", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "-1"], "--process-id -1 not in 0..1"),
] + REFUSED_MESHES)
def test_train_launcher_refusals(capsys, extra, message):
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--smoke", "--device", "cpu", "--steps", "1"] + extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_train_step_refuses_what_waits_for_item_13b_2():
    """The library step refuses the same, for callers past the launcher."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.train_loop import make_train_step

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

        def __init__(self, shape):
            self.shape = shape

    dense = build_model(get_smoke_config("smollm_135m"), device="cpu")
    moe = build_model(get_smoke_config("deepseek_moe_16b"), device="cpu")
    for model, shape, message in ((dense, (1, 2, 2), "a model axis of 2"),
                                  (moe, (2, 1, 1), "an MoE layer on a mesh")):
        with pytest.raises(ValueError, match=f"{message}.*item 13b-2"):
            make_train_step(model, TrainConfig(), mesh=Mesh(shape))
