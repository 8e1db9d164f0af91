"""Package rules of the port: no JAX, no ``repro``, no silent CPU fallback."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import BlockPool, Request, Scheduler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)")


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_every_module_without_jax():
    code = ("import sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        PKG.rglob("*.py")) + ["chip_smoke.py"])
def test_no_jax_or_repro_imports(path):
    for i, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        assert not IMPORT_RE.match(line), f"{path}:{i}: {line.strip()}"


def test_launcher_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the refusal path is for CUDA-less torch")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--continuous", "--smoke", "--requests", "1"])


def test_chip_smoke_refuses_without_cuda():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# block pool and scheduler accounting (the JAX invariants of
# tests/test_serve_continuous.py::TestBlockPool)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    return build_model(get_smoke_config("llama3_1b"), device="cpu")


def test_pool_alloc_extend_free(smoke_model):
    pool = BlockPool(smoke_model, num_blocks=16, block_size=4, max_requests=4)
    assert pool.free_blocks == 15
    pool.alloc(1, 10)
    assert len(pool.table(1)) == 3 and 0 not in pool.table(1)
    pool.extend(1, 12)
    assert len(pool.table(1)) == 3
    pool.extend(1, 13)
    assert len(pool.table(1)) == 4 and pool.free_blocks == 11
    pool.alloc(2, 4)
    assert set(pool.table(1)).isdisjoint(pool.table(2))
    t = pool.padded_tables([1, 2], rows=4, blocks=8)
    assert t.dtype == np.int32 and t.shape == (4, 8)
    assert (t[2:] == 0).all() and (t[1, 1:] == 0).all()
    pool.free(1)
    pool.free(2)
    assert pool.free_blocks == 15


def test_pool_exhaustion_and_reuse_zeroes_pages(smoke_model):
    pool = BlockPool(smoke_model, num_blocks=4, block_size=4, max_requests=2)
    pool.alloc(1, 12)
    blk = pool.table(1)[0]
    pool.pages[0]["k"][blk] = 7.0
    with pytest.raises(MemoryError):
        pool.alloc(2, 4)
    with pytest.raises(MemoryError):
        pool.extend(1, 13)
    pool.free(1)
    pool.alloc(3, 12)
    assert blk in pool.table(3)
    assert pool.pages[0]["k"][blk].eq(0).all()


def test_scheduler_admits_fifo_and_preempts_youngest(smoke_model):
    pool = BlockPool(smoke_model, num_blocks=9, block_size=4, max_requests=3)
    sched = Scheduler(pool, max_running=3)
    reqs = [Request(req_id=i, prompt=np.arange(6, dtype=np.int32),
                    max_new_tokens=6) for i in range(3)]
    for r in reqs:
        sched.submit(r)
    admitted = sched.admit()           # 3 blocks each of 8 usable: two fit
    assert [r.req_id for r in admitted] == [0, 1]
    for r in admitted:
        pool.alloc(r.req_id, len(r.prompt))
    victim = sched.preempt_youngest()
    assert victim.req_id == 1 and victim.preemptions == 1
    assert [r.req_id for r in sched.waiting] == [1, 2]
    assert sched.preemptions == 1 and pool.free_blocks == 6
