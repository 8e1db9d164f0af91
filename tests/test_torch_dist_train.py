"""Training over the pod and data axes (``--mesh P,D,1``) of the port on
gloo ranks of the CPU, against the JAX package's on fake devices.

One JAX subprocess on 8 fake host devices serves the module through a
module-scoped fixture: the reference's ``quantized_mean_leaf`` in a
``shard_map`` over two pods, its ``make_compressed_grads_fn`` on the
(2, 2, 2) quadratic case of tests/test_dist.py (and on random weights), and
its train launcher at ``--mesh 2,2,1 --grad-compress`` and at ``--mesh
1,4,1`` (the jitted step with ``train_state_specs(strategy="fsdp")``),
recording each step's CE. While it runs, the fixture runs the port: its
launcher at the same meshes, at 1,1,1, resumed from the reference's
checkpoint, resumed elastically (1,4,1's step 1 at 1,2,1 and 1,1,1, 2,2,1
--grad-compress's at 2,1,1, the residuals' rows resharded), and at 1,2,1
through ``--coordinator`` with a second process. Both packages start from
one state: the port's SMOKE init written by the port as a checkpoint at step
-1 (so both launchers "resume" at step 0), and both read the same seeded
numpy tokens (``NumpyTokens`` stands in for either pipeline; torch's RNG
cannot give jax.random's tokens).

Tolerances:
- ``quantized_mean_leaf`` on the same inputs: ĝ bit for bit (the same int8
  rounding, half to even, and for two pods ĝ = (d0 + d1) / 2 either way);
  the residual g + e - q·s within 2^-23 of the largest |g + e| (XLA's
  jitted CPU code may fuse the product into the subtraction, one rounding
  fewer).
- ``make_compressed_grads_fn``: ĝ and the residuals within 1e-6. The
  per-pod gradient is a reduction over other partitions in each package, so
  a value on a rounding tie of the int8 grid may round the other way; there
  the difference may reach one quantum of its block (the block's scale for
  the residual, scale / 2 for ĝ), and at most 1% of the values may differ
  so. The error-feedback invariant ĝ + mean_p(e_p) = mean_p(g_p + e_p,prev)
  holds to 1e-6 on the two ranks' outputs, each rank's local identities
  (``ef_own``, ``ef_sum``) within one fp32 rounding of the largest |g + e|.
- The launchers (fp32 SMOKE, lr 3e-3 after a 5-step warmup): CE at every
  step rtol 1e-5; parameters, moments and residuals within 1e-5 + 1e-5 of
  the leaf's largest entry, but for ``LOOSE_SHARE`` (1e-3) of a leaf's
  elements and ``LOOSE_EXTRA`` (2) more: an element whose gradient is
  within rounding of 0 may see AdamW's first step m̂ / sqrt(v̂) flip sign,
  and under grad compression a value on a tie of the int8 grid rounds the
  other way (its residual moves by one quantum, ĝ by half of one, and the
  moments follow). Those elements keep a bound: parameters 2·lr a step
  taken, residuals twice the leaf's largest. At 2,2,1 --grad-compress the
  tight share holds at step 1; at the last step the step-1 differences have
  gone through a forward and a backward, so up to ``DRIFT_SHARE`` (0.1) of
  a leaf may leave the tight bound, within the same bounds.
- The shares are read from ``census`` (at the end of this file) over init
  seeds 0-11, the most elements beyond the tight bound in any one leaf:
  2,2,1 against the reference 10 of 24,576 at step 1 and 1,062 of 24,576 at
  step 2 (seed 1, ``err/embed``; 75 of 36,864 the next); 1,4,1 against the
  reference 7 of 12,288; resumed from the reference 3 of 18,432; the port
  against itself (1,4,1 and 1,1,1, the elastic resumes) 2 of 36,864.
- The port against itself: at 1,4,1 and 1,1,1 CE rtol 1e-5 and leaves as
  above (the mean of 4 ranks' gradients against one backward over 8 rows);
  the elastic resumes within the same bounds of the uninterrupted run, and
  at 2,1,1 each rank's restored residuals bit for bit its pod's row of the
  stored ones; ``--coordinator`` equal bit for bit to the spawned run of the
  same mesh (the same ranks, one CPU thread each); every rank's parameters
  the same bits at every step.
"""
import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import reference_leaves
from repro_torch.dist import group
from repro_torch.dist.sharding import batch_shard, to_named
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.train import grad_compress as tgc
from repro_torch.train.train_loop import make_train_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JOIN_S = 400.0
STEPS = 3
ARGS = ["--smoke", "--steps", str(STEPS), "--ckpt-every", "1", "--seq", "32",
        "--batch", "8"]
LR_SUM = 3e-3 * (1 + 2 + 3) / 5          # lr at steps 0, 1, 2 of the warmup
# the share of a leaf's elements (and a count more) that may leave the tight
# bound, and the share at 2,2,1's last step against the reference (see the
# module docstring and ``census``)
LOOSE_SHARE, LOOSE_EXTRA, DRIFT_SHARE = 1e-3, 2, 0.1
QUAD = {"w": (256,), "v": (7, 33)}       # the quadratic case's leaves
# the elastic resumes: 1,4,1's step-1 checkpoint at a data axis of 2 and 1,
# 2,2,1 --grad-compress's at 2,1,1 (the residuals' rows resharded)
ELASTIC = ("1,2,1", "1,1,1", "2,1,1")


def np_tokens(step: int, b: int, t: int, vocab: int) -> np.ndarray:
    return np.random.RandomState(1000 + step).randint(0, vocab, (b, t)).astype(np.int32)


class NumpyTokens:
    """The port pipeline's stand-in: ``np_tokens`` batches as tensors."""

    def __init__(self, dcfg, model_cfg=None, *, device="cpu"):
        self.dcfg, self.device = dcfg, device

    def get_batch(self, step):
        d = self.dcfg
        return {"tokens": torch.from_numpy(
            np_tokens(step, d.global_batch, d.seq_len, d.vocab_size)).to(self.device)}


JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.train import grad_compress as gc
    import repro.launch.train as lt

    d, args = sys.argv[1], json.loads(sys.argv[2])

    def tokens(step, b, t, vocab):
        return np.random.RandomState(1000 + step).randint(0, vocab, (b, t)).astype(np.int32)

    class NumpyTokens:
        def __init__(self, dcfg, model_cfg=None):
            self.dcfg = dcfg
        def get_batch(self, step):
            c = self.dcfg
            return {"tokens": jnp.asarray(tokens(step, c.global_batch, c.seq_len,
                                                 c.vocab_size))}

    # quantized_mean_leaf over two pods, on the same inputs as the port
    q = np.load(f"{d}/leaf_inputs.npz")
    pod = jax.make_mesh((2,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
    def leaf(g, e):
        g_hat, new_e = gc.quantized_mean_leaf(g[0], e[0], "pod")
        return g_hat, new_e[None]
    f = jax.jit(jax.shard_map(leaf, mesh=pod, in_specs=(P("pod"), P("pod")),
                              out_specs=(P(), P("pod")), check_vma=False))
    g_hat, new_e = f(jnp.asarray(q["g"]), jnp.asarray(q["e"]))
    np.savez(f"{d}/jax_leaf.npz", g_hat=np.asarray(g_hat), err=np.asarray(new_e))

    # make_compressed_grads_fn on the (2, 2, 2) mesh, two steps
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    def loss_and_grad(params, batch):
        def loss(p):
            return (jnp.mean((p["w"] * batch["x"] - 1.0) ** 2)
                    + jnp.mean((p["v"] * batch["y"] - 1.0) ** 2))
        l, g = jax.value_and_grad(loss)(params)
        return (l, {"ce": l, "aux": jnp.zeros(())}), g
    cg = jax.jit(gc.make_compressed_grads_fn(
        loss_and_grad, mesh, lambda leaf: P("pod", *([None] * (leaf.ndim - 1)))))
    for case in ("ref", "random"):
        z = np.load(f"{d}/quad_{case}.npz")
        params = {"w": jnp.asarray(z["w"]), "v": jnp.asarray(z["v"])}
        batch = {"x": jnp.asarray(z["x"]), "y": jnp.asarray(z["y"])}
        err = gc.init_error_state(params, 2)
        out = {}
        for step in range(2):
            loss, metrics, grads, err = cg(params, batch, err)
            out.update({f"{step}:loss": np.asarray(loss)})
            for k in ("w", "v"):
                out[f"{step}:g:{k}"] = np.asarray(grads[k])
                out[f"{step}:e:{k}"] = np.asarray(err[k])
        np.savez(f"{d}/jax_quad_{case}.npz", **out)

    # the train launcher, each step's CE recorded around its jitted step
    lt.TokenPipeline = NumpyTokens
    ces, jit = [], jax.jit
    def recording_jit(fn, **kw):
        j = jit(fn, **kw)
        def call(*a, **k):
            out = j(*a, **k)
            if isinstance(out, tuple) and isinstance(out[-1], dict) and "ce" in out[-1]:
                ces.append(float(out[-1]["ce"]))
            return out
        return call
    lt.jax.jit = recording_jit
    for name, extra in (("221", ["--mesh", "2,2,1", "--grad-compress"]),
                        ("141", ["--mesh", "1,4,1"])):
        ces.clear()
        sys.argv = ["train"] + args + extra + ["--ckpt-dir", f"{d}/jax{name}"]
        lt.main()
        json.dump(ces, open(f"{d}/jax{name}_ce.json", "w"))
    print("OK")
""")


def _quad_inputs(case: str):
    if case == "ref":                      # tests/test_dist.py's case
        w, v = np.ones(QUAD["w"], np.float32), np.ones(QUAD["v"], np.float32)
        x = np.concatenate([np.ones((2, 256)), 2 * np.ones((2, 256))]).astype(np.float32)
        y = np.concatenate([np.ones((2, 7, 33)), 3 * np.ones((2, 7, 33))]).astype(np.float32)
    else:
        rng = np.random.RandomState(7)
        w, v = (rng.standard_normal(s).astype(np.float32) for s in QUAD.values())
        x = rng.standard_normal((4, 256)).astype(np.float32)
        y = rng.standard_normal((4, 7, 33)).astype(np.float32)
    return dict(w=w, v=v, x=x, y=y)


def _initial_checkpoint(d: Path, n_pods: int, seed: int) -> None:
    """The port's SMOKE init from ``seed`` as step -1 (a fresh AdamW state,
    zero residuals for ``n_pods`` pods, none for 0), as both launchers read
    it."""
    model = build_model(get_smoke_config("smollm_135m"), device="cpu")
    state = make_train_state(model, torch.Generator().manual_seed(seed),
                             TrainConfig(grad_compress_pods=bool(n_pods)))
    if n_pods:
        state["err"] = tgc.init_error_state(dict(model.named_parameters()), n_pods)
    CheckpointManager(str(d)).save(-1, state)


def port_quad(d: str) -> dict:
    """Every rank's part of the quantizer cases on a (2, 1, 1) mesh: its row
    through ``quantized_mean_leaf``, and two steps of
    ``make_compressed_grads_fn`` per case."""
    d = Path(d)
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu")
    me = dist.get_rank()
    q = np.load(d / "leaf_inputs.npz")
    g_hat, new_e = tgc.quantized_mean_leaf(torch.from_numpy(q["g"][me]),
                                           torch.from_numpy(q["e"][me]),
                                           mesh.get_group("pod"))
    out = {"leaf": (g_hat.numpy(), new_e.numpy())}

    def loss_and_grad(params, batch):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = (torch.mean((p["w"] * batch["x"] - 1.0) ** 2)
                + torch.mean((p["v"] * batch["y"] - 1.0) ** 2))
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        return (loss.detach(), {"ce": loss.detach(), "aux": torch.zeros(())}), grads

    f = tgc.make_compressed_grads_fn(loss_and_grad, mesh)
    for case in ("ref", "random"):
        z = {k: torch.from_numpy(v) for k, v in _quad_inputs(case).items()}
        params = {"w": z["w"], "v": z["v"]}
        err = {k: torch.zeros((1,) + tuple(v.shape)) for k, v in params.items()}
        steps = []
        for _ in range(2):
            loss, _, grads, err, stats = f(params, {"x": z["x"], "y": z["y"]}, err)
            steps.append((float(loss), {k: g.numpy().copy() for k, g in grads.items()},
                          {k: e[0].numpy().copy() for k, e in err.items()}, stats))
        out[case] = steps
    return out


def _launch(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launch_train.main(args)
    res["stdout"] = buf.getvalue()
    return res


def _keep_up_to(src, dst, last):
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if name.startswith("step_") and int(name[5:]) > last:
            shutil.rmtree(os.path.join(dst, name))


def _leaves(d, step):
    path = Path(d) / f"step_{step}"
    meta = json.loads((path / "manifest.json").read_text())
    return {p: np.load(path / f"leaf_{i}.npy") for i, p in enumerate(meta["paths"])}


def _elastic_source(mesh: str) -> str:
    return "port221" if mesh[0] == "2" else "port141"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def produce(d: Path, seed: int) -> dict:
    """The reference's results (npz / json by name) and the port's runs in
    ``d``, both packages from the port's SMOKE init of ``seed``."""
    rng = np.random.RandomState(3)
    np.savez(d / "leaf_inputs.npz",
             g=rng.standard_normal((2, 300)).astype(np.float32) * 0.1,
             e=rng.standard_normal((2, 300)).astype(np.float32) * 1e-3)
    for case in ("ref", "random"):
        np.savez(d / f"quad_{case}.npz", **_quad_inputs(case))
    for name, pods in (("jax221", 2), ("port221", 2), ("jax141", 0),
                       ("port141", 0), ("port111", 0)):
        _initial_checkpoint(d / name, pods, seed)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d), json.dumps(ARGS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=d)
    port = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(launch_train, "TokenPipeline", NumpyTokens)
            port["quad"] = group.run(2, port_quad, (str(d),), device="cpu",
                                     timeout=JOIN_S)
            base = ARGS + ["--device", "cpu"]
            port["221"] = _launch(base + ["--mesh", "2,2,1", "--grad-compress",
                                          "--ckpt-dir", str(d / "port221")])
            port["141"] = _launch(base + ["--mesh", "1,4,1",
                                          "--ckpt-dir", str(d / "port141")])
            port["111"] = _launch(base + ["--ckpt-dir", str(d / "port111")])
            for mesh in ELASTIC:
                _keep_up_to(d / _elastic_source(mesh), d / f"elastic{mesh}", 1)
                extra = ["--grad-compress"] if mesh[0] != "1" else []
                port[f"elastic{mesh}"] = _launch(base + extra + [
                    "--mesh", mesh, "--ckpt-dir", str(d / f"elastic{mesh}")])
            _keep_up_to(d / "port141", d / "coord", 1)
            addr = f"127.0.0.1:{_free_port()}"
            coord = ["--mesh", "1,2,1", "--ckpt-dir", str(d / "coord"),
                     "--coordinator", addr, "--num-processes", "2"]
            other = subprocess.Popen(
                [sys.executable, "-c", COORD_SCRIPT, json.dumps(
                    base + coord + ["--process-id", "1"])],
                env=dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO / 'tests'}",
                         OMP_NUM_THREADS="1"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                port["coord"] = _launch(base + coord + ["--process-id", "0"])
                o_out, o_err = other.communicate(timeout=JOIN_S)
            finally:
                if other.poll() is None:
                    other.kill()
                    other.communicate()
            assert other.returncode == 0, o_err[-3000:]
            port["coord_other"] = json.loads(o_out.strip().splitlines()[-1])
        out, err = jax_run.communicate(timeout=JOIN_S)
        assert jax_run.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err[-5000:]}"
        # the port resumes from the reference's checkpoint cut to step 1
        _keep_up_to(d / "jax221", d / "resumed", 1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(launch_train, "TokenPipeline", NumpyTokens)
            port["resumed"] = _launch(ARGS + ["--device", "cpu", "--mesh", "2,2,1",
                                              "--grad-compress",
                                              "--ckpt-dir", str(d / "resumed")])
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    ref = {}
    for f in d.glob("jax_*.npz"):
        with np.load(f) as z:
            ref[f.stem[4:]] = {k: z[k] for k in z.files}
    for name in ("221", "141"):
        ref[f"ce{name}"] = json.loads((d / f"jax{name}_ce.json").read_text())
    return {"dir": d, "port": port, "ref": ref}


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        yield produce(Path(tmp), 0)


# the second process of --coordinator: rank 1, its numbers as a JSON line
COORD_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import train
    import test_torch_dist_train as t
    train.TokenPipeline = t.NumpyTokens
    res = train.main(json.loads(sys.argv[1]))
    print(json.dumps({"ce": res["ce"], "digest": res["ranks"][0]["digest"],
                      "rank": res["ranks"][0]["rank"]}))
""")


def _loose(got, want) -> dict:
    """{leaf: (elements beyond 1e-5 + 1e-5·max|leaf|, the leaf's size, the
    largest difference, the bound it must keep)}; the step counter aside."""
    assert list(got) == list(want)
    out = {}
    for p, w in want.items():
        g = got[p]
        assert g.shape == w.shape and g.dtype == w.dtype, p
        if p == "opt/step":
            assert int(g) == int(w)
            continue
        diff = np.abs(g.astype(np.float64) - w)
        loose = diff > 1e-5 + 1e-5 * np.abs(w).max()
        if p.startswith("err/"):
            # a flipped int8 value: the residual moves by one quantum, and a
            # residual lies within half a quantum of 0
            bound = 2 * np.abs(w).max() * 1.001
        else:
            bound = 2 * LR_SUM if p.startswith("params/") else np.inf
        out[p] = (int(loose.sum()), loose.size, float(diff[loose].max(initial=0.0)), bound)
    return out


def _close_leaves(got, want, label, share=LOOSE_SHARE):
    """Every leaf within 1e-5 + 1e-5·max|leaf|, but for at most ``share`` of
    a leaf's elements and ``LOOSE_EXTRA`` more (AdamW sign flips at
    near-zero gradients; under grad compression also int8 ties), which must
    keep their bound: parameters within 2·lr a step, residuals within one
    quantum."""
    for p, (n, size, worst, bound) in _loose(got, want).items():
        assert n <= share * size + LOOSE_EXTRA, (label, p, n, worst)
        assert worst <= bound, (label, p, worst)


def _check_quantized(got, want, quantum, what):
    """``got`` within 1e-6 of ``want``, but for values a rounding tie moved
    by one quantum (``quantum``: its size at each element); at most 1% so."""
    diff = np.abs(got.astype(np.float64) - want)
    off = diff > 1e-6
    assert off.mean() <= 0.01, (what, int(off.sum()))
    assert (diff[off] <= quantum[off] * 1.001 + 1e-6).all(), (what, float(diff.max()))


def _pod_grads(case: str):
    """Each pod's exact gradient of the quadratic case (float64): pod p's
    rows 2p, 2p + 1, the loss a mean over each leaf's elements."""
    z = _quad_inputs(case)
    out = []
    for rows in (slice(0, 2), slice(2, 4)):
        g = {}
        for k, xk in (("w", "x"), ("v", "y")):
            w, x = z[k].astype(np.float64), z[xk][rows].astype(np.float64)
            g[k] = 2 * ((w * x - 1.0) * x).sum(0) / x.size
        out.append(g)
    return out


def _quantum(target: np.ndarray) -> np.ndarray:
    """The int8 step (the block's scale) at each element of ``target``."""
    flat = np.abs(target.reshape(-1))
    blocks = np.concatenate([flat, np.zeros((-flat.size) % 128)]).reshape(-1, 128)
    return np.repeat(blocks.max(1) / 127, 128)[:flat.size].reshape(target.shape)


# ---------------------------------------------------------------------------
# the quantizer's pod reduction
# ---------------------------------------------------------------------------

def test_quantized_mean_leaf_matches_reference(runs):
    ref = runs["ref"]["leaf"]
    with np.load(runs["dir"] / "leaf_inputs.npz") as z:
        target = np.abs(z["g"] + z["e"]).max()
    for rank, r in enumerate(runs["port"]["quad"]):
        g_hat, new_e = r["leaf"]
        np.testing.assert_array_equal(g_hat, ref["g_hat"])
        np.testing.assert_allclose(new_e, ref["err"][rank], rtol=0, atol=2.0 ** -23 * target)


@pytest.mark.parametrize("case", ["ref", "random"])
def test_compressed_grads_match_reference(runs, case):
    """Two steps of ``make_compressed_grads_fn`` on two ranks against the
    reference's on its (2, 2, 2) mesh: ĝ equal on both ranks and within
    1e-6 of the reference's, each pod's residual too (a tie: one quantum),
    the invariant within 1e-6, the loss (the mean over pods) at rtol 1e-6,
    and the bytes each rank sent."""
    want = runs["ref"][f"quad_{case}"]
    ranks = [r[case] for r in runs["port"]["quad"]]
    pod_g = _pod_grads(case)
    n = sum(int(np.prod(s)) for s in QUAD.values())
    blocks = sum(-(-int(np.prod(s)) // 128) for s in QUAD.values())
    for step in range(2):
        assert ranks[0][step][0] == ranks[1][step][0]
        np.testing.assert_allclose(ranks[0][step][0], float(want[f"{step}:loss"]),
                                   rtol=1e-6)
        for k in QUAD:
            quanta = []
            for rank, r in enumerate(ranks):
                prev = r[step - 1][2][k] if step else 0.0
                quanta.append(_quantum(pod_g[rank][k] + prev))
                _check_quantized(r[step][2][k], want[f"{step}:e:{k}"][rank], quanta[-1],
                                 f"{case} step {step} err {k} rank {rank}")
            g_hat = ranks[0][step][1][k]
            np.testing.assert_array_equal(ranks[1][step][1][k], g_hat)
            _check_quantized(g_hat, want[f"{step}:g:{k}"], np.maximum(*quanta) / 2,
                             f"{case} step {step} ĝ {k}")
        # the error feedback's invariant from both pods' outputs: ĝ +
        # mean_p(e_p) = mean_p(g_p + e_p,prev), the pod gradients exact
        for k in QUAD:
            lhs = ranks[0][step][1][k] + (ranks[0][step][2][k] + ranks[1][step][2][k]) / 2
            rhs = sum(pod_g[p][k] + (ranks[p][step - 1][2][k] if step else 0.0)
                      for p in range(2)) / 2
            np.testing.assert_allclose(lhs, rhs, rtol=0, atol=1e-6 * max(1.0, abs(rhs).max()))
        for r in ranks:
            stats = r[step][3]
            # the local identities: exact but for one fp32 rounding
            assert stats["ef_own"] <= 2.0 ** -23 * stats["ef_scale"], stats
            assert stats["ef_sum"] == 0.0, stats       # two pods: ĝ·2 is exact
            # int8 payload + fp32 scales to the other pod, the 3 metric scalars'
            assert stats["bytes_sent"] == (128 * blocks + 4 * blocks) + 12
    assert n < 128 * blocks


def test_quantized_mean_on_one_rank_is_the_round_trip():
    """A pod axis of one rank: ĝ is the quantize → dequantize round trip of
    g + e (the reference quantizes with one pod too), nothing sent."""
    g = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    e = torch.randn(1000, generator=torch.Generator().manual_seed(6)) * 1e-3
    g_hat, new_e, stats = tgc.quantized_mean({"g": g}, {"g": e})
    np.testing.assert_array_equal(g_hat["g"].numpy(),
                                  tgc.simulate_roundtrip(g + e).numpy())
    np.testing.assert_array_equal(new_e["g"].numpy(), (g + e - g_hat["g"]).numpy())
    assert stats["bytes_sent"] == 0 and stats["ef_sum"] == 0.0
    assert stats["ef_scale"] == float((g + e).abs().max())
    assert stats["ef_own"] <= 2.0 ** -23 * stats["ef_scale"]
    assert tgc.error_state_specs({"a": g, "b": e}) == {"a": ("pod",), "b": ("pod",)}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_grad_compress_matches_reference(runs):
    """``--mesh 2,2,1 --grad-compress``: four ranks, CE at every step, the
    last checkpoint's parameters, moments and residuals (2, ...) against
    the reference launcher's; the error-feedback invariant every step."""
    res, d = runs["port"]["221"], runs["dir"]
    np.testing.assert_allclose(res["ce"], runs["ref"]["ce221"], rtol=1e-5)
    assert [r["rank"] for r in res["ranks"]] == [0, 1, 2, 3]
    assert [(r["pod"], r["data"]) for r in res["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for step, share in ((STEPS - 2, LOOSE_SHARE), (STEPS - 1, DRIFT_SHARE)):
        got, want = _leaves(d / "port221", step), _leaves(d / "jax221", step)
        assert all(want[p].shape[0] == 2 for p in want if p.startswith("err/"))
        _close_leaves(got, want, f"2,2,1 step {step}", share)
    for r in res["ranks"]:
        assert len(r["error_feedback"]) == STEPS
        for own, total, scale in r["error_feedback"]:
            # the pod invariant's bound from the local identities
            assert own + total / 2 <= 16 * 2.0 ** -24 * scale, (own, total, scale)


def test_every_rank_holds_the_same_bits(runs):
    for key in ("221", "141", "elastic1,2,1", "elastic2,1,1"):
        ranks = runs["port"][key]["ranks"]
        assert len({tuple(r["fingerprints"]) for r in ranks}) == 1, key
        assert len(ranks[0]["fingerprints"]) == len(ranks[0]["ce"]) > 0
        assert len({r["digest"] for r in ranks}) == 1, key
        assert len({tuple(r["ce"]) for r in ranks}) == 1, key


def test_launcher_counts_bytes_and_saves(runs):
    """Per rank and step: the fp32 data mean (a ring over 2 ranks sends the
    gradient's bytes once), the int8 payload and fp32 scales to the other
    pod, the metrics; rank 0 alone writes."""
    res = runs["port"]["221"]
    model = build_model(get_smoke_config("smollm_135m"), device="cpu")
    sizes = {k: p.numel() for k, p in model.named_parameters()}
    n = sum(sizes.values())
    # the reference's leaves: a stacked leaf's blocks span its layers
    blocks = sum(-(-sum(sizes[k] for k in leaf) // 128)
                 for leaf in reference_leaves(model))
    want = 4 * n + (128 * blocks + 4 * blocks) + 2 * 3 * 12 // 4
    for r in res["ranks"]:
        assert r["bytes_sent"] == [want] * STEPS
    assert [(s["step"], s["blocking"]) for s in res["saves"]] == \
        [(1, False), (2, False), (2, True)]
    assert res["ckpt_steps"] == [-1, 1, 2]
    assert "[rank 3] pod 1 data 1" in res["stdout"]
    plain = runs["port"]["141"]["ranks"][0]["bytes_sent"]
    assert plain == [2 * 3 * 4 * n // 4 + 2 * 3 * 8 // 4] * STEPS


def test_mesh_step_matches_reference_and_single_device(runs):
    """``--mesh 1,4,1`` (the plain fp32 mean over four ranks) against the
    reference's jitted FSDP step on a fake (1, 4, 1) mesh, and against the
    port's own single-device step on the same 8 rows."""
    d, port = runs["dir"], runs["port"]
    np.testing.assert_allclose(port["141"]["ce"], runs["ref"]["ce141"], rtol=1e-5)
    np.testing.assert_allclose(port["141"]["ce"], port["111"]["ce"], rtol=1e-5)
    last = _leaves(d / "port141", STEPS - 1)
    _close_leaves(last, _leaves(d / "jax141", STEPS - 1), "1,4,1 vs reference")
    _close_leaves(last, _leaves(d / "port111", STEPS - 1), "1,4,1 vs 1,1,1")


def test_jax_manager_restores_the_port_mesh_checkpoint(runs):
    import jax
    import jax.numpy as jnp
    from repro.ckpt import CheckpointManager as JManager
    from repro.ckpt.checkpoint import _flatten_with_paths
    d = runs["dir"]
    want = _leaves(d / "port221", STEPS - 1)
    like = _leaves(d / "jax221", STEPS - 1)
    tree = {"err": {}, "opt": {}, "params": {}}
    # the reference's tree rebuilt from its own manifest: restore reads the
    # port's files into it
    meta = json.loads((d / "jax221" / f"step_{STEPS - 1}" / "manifest.json").read_text())
    for p in meta["paths"]:
        node = tree
        *parents, leaf = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.zeros_like(like[p])
    restored, meta2 = JManager(str(d / "port221")).restore(jax.tree.map(lambda x: x, tree))
    paths, leaves, _ = _flatten_with_paths(restored)
    assert paths == list(want) and meta2["step"] == STEPS - 1
    for p, x in zip(paths, leaves):
        np.testing.assert_array_equal(np.asarray(x), want[p], err_msg=p)


def test_port_resumes_the_reference_mesh_checkpoint(runs):
    res, d = runs["port"]["resumed"], runs["dir"]
    assert "[resume] step 1" in res["stdout"] and res["start"] == 2
    np.testing.assert_allclose(res["ce"], runs["ref"]["ce221"][2:], rtol=1e-5)
    _close_leaves(_leaves(d / "resumed", STEPS - 1), _leaves(d / "jax221", STEPS - 1),
                  "resumed from the reference")


def _stored_rows_digest(d: Path, step: int, pod: int) -> str:
    """sha256 of row ``pod`` of every residual stored at ``step`` in ``d``,
    as the launcher digests the rows a rank restored (read whole, without
    the reshard)."""
    model = build_model(get_smoke_config("smollm_135m"), device="cpu")
    state = make_train_state(model, None, TrainConfig(grad_compress_pods=True))
    state["err"] = tgc.init_error_state(dict(model.named_parameters()), 2)
    CheckpointManager(str(d)).restore(state, step=step)
    return launch_train._digest((k, e[pod:pod + 1]) for k, e in state["err"].items())


@pytest.mark.parametrize("mesh", ELASTIC)
def test_elastic_resume_matches_the_uninterrupted_run(runs, mesh):
    """A step-1 checkpoint resumed at a smaller data axis, against the
    uninterrupted run: CE, parameters, moments and (2,1,1) residuals; each
    rank's restored residuals bit for bit its pod's row of the stored ones."""
    res, d = runs["port"][f"elastic{mesh}"], runs["dir"]
    src = _elastic_source(mesh)
    n_ranks = int(mesh[0]) * int(mesh[2])
    assert res["start"] == 2 and len(res["ranks"]) == n_ranks
    np.testing.assert_allclose(res["ce"], runs["port"][src[4:]]["ce"][2:], rtol=1e-5)
    got, want = _leaves(d / f"elastic{mesh}", STEPS - 1), _leaves(d / src, STEPS - 1)
    assert any(p.startswith("err/") for p in want) == (mesh[0] == "2")
    _close_leaves(got, want, f"{src} -> {mesh}")
    if mesh[0] == "2":
        rows = [_stored_rows_digest(d / src, 1, pod) for pod in range(2)]
        assert rows[0] != rows[1]
        assert [r["restored_err"] for r in res["ranks"]] == rows


def test_coordinator_matches_the_spawned_run(runs):
    """Two processes joining over TCP at 1,2,1 equal, bit for bit, the
    launcher's spawned ranks at 1,2,1 from the same checkpoint."""
    port, d = runs["port"], runs["dir"]
    spawned = port["elastic1,2,1"]
    assert port["coord"]["ce"] == spawned["ce"] == port["coord_other"]["ce"]
    assert [r["rank"] for r in port["coord"]["ranks"]] == [0]
    assert port["coord_other"]["rank"] == 1
    assert port["coord"]["ranks"][0]["digest"] == port["coord_other"]["digest"] == \
        spawned["ranks"][0]["digest"]
    got, want = _leaves(d / "coord", STEPS - 1), _leaves(d / "elastic1,2,1", STEPS - 1)
    for p, w in want.items():
        np.testing.assert_array_equal(got[p], w, err_msg=p)


def _restore_on_mesh(d: str, shape):
    mesh = make_mesh(shape, ("pod", "data", "model"), device="cpu")
    model = build_model(get_smoke_config("smollm_135m"), device="cpu")
    state = make_train_state(model, None, TrainConfig(grad_compress_pods=True))
    state["err"] = tgc.init_error_state(dict(model.named_parameters()), 1)
    CheckpointManager(d).restore(state, shardings=to_named(
        {"err": tgc.error_state_specs(model)}, mesh))


def test_a_change_of_pod_count_raises(runs):
    with pytest.raises(RuntimeError, match=r"err/.*: the checkpoint holds the residuals "
                       r"of 2 pods, the mesh has 1: a restore may change the data axis "
                       r"but not the pod count"):
        group.run(1, _restore_on_mesh, (str(runs["dir"] / "port221"), (1, 1, 1)),
                  device="cpu", timeout=60)
    assert not dist.is_initialized()


def test_batch_shard_takes_the_pod_major_rows():
    class Mesh:
        shape, mesh_dim_names = (2, 2, 1), ("pod", "data", "model")

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    batch = {"tokens": torch.arange(16).reshape(8, 2)}
    for r, coord in enumerate([(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]):
        rows = batch_shard(batch, Mesh(coord))["tokens"]
        assert rows[:, 0].tolist() == [4 * r, 4 * r + 2]
    with pytest.raises(ValueError, match="6 rows do not split over 4 ranks"):
        batch_shard({"tokens": torch.zeros(6, 2)}, Mesh((0, 0, 0)))


# ---------------------------------------------------------------------------
# the census behind LOOSE_SHARE and LOOSE_EXTRA:
#   PYTHONPATH=src python tests/test_torch_dist_train.py 0 1 2 3
# runs the fixture's runs from each init seed and prints, for every
# comparison the tests make with ``_close_leaves``, the leaf with the most
# elements beyond the tight bound
# ---------------------------------------------------------------------------

def _comparisons(r):
    d = r["dir"]
    last = STEPS - 1
    pairs = [("2,2,1 vs reference", "port221", "jax221", last - 1),
             ("2,2,1 vs reference", "port221", "jax221", last),
             ("1,4,1 vs reference", "port141", "jax141", last),
             ("1,4,1 vs 1,1,1", "port141", "port111", last),
             ("resumed from the reference", "resumed", "jax221", last)]
    pairs += [(f"{_elastic_source(m)} -> {m}", f"elastic{m}", _elastic_source(m), last)
              for m in ELASTIC]
    for label, a, b, step in pairs:
        yield f"{label} step {step}", _leaves(d / a, step), _leaves(d / b, step)


def census(seeds) -> None:
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            r = produce(Path(tmp), seed)
            for label, got, want in _comparisons(r):
                counts = _loose(got, want)
                p, (n, size, worst, bound) = max(counts.items(), key=lambda kv: kv[1][0])
                share = max(c[0] / c[1] for c in counts.values())
                print(f"seed {seed} {label}: most loose {n} of {size} in {p} "
                      f"(largest diff {worst:.3e}, bound {bound:.3e}); largest share "
                      f"{share:.2e}; leaves with any {sum(c[0] > 0 for c in counts.values())}"
                      f" of {len(counts)}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_dist_train as t
    t.census([int(x) for x in sys.argv[1:]] or [0])
