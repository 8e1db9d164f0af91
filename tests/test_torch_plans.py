"""The launch plans of ``lowrank_linear`` at every factored projection of
the seven attention-only full-width configs, on the CPU (deepseek-v2's MLA
projections ``wq``, ``w_dkv`` and ``wo`` among them).

For ratios 0.6 and 0.3, M 1, 8, 16, 40, 256 and 4608 (the long prefill
of gemma2's serving path), fp32 and bf16: each product's plan passes a
Python mirror of the CUDA source's ``plan_ok``
(``csrc/lowrank_linear.cu``: splits cover K, each non-empty, kchunk a
multiple of the kernel's K step and within its k bound), its grid fits the
launch limits, and its workspace and counters fit the scratch of
``scratch_layout``, which ``reserve_scratch`` then holds without being
replaced. gemma2's ``down`` (K 36864) is the planner's one case past its
aimed-for split count.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import lowrank_linear as tll
from repro_torch.models.linear import rank_for_ratio

torch.set_num_threads(1)

FAMILIES = ["mistral_7b", "smollm_135m", "olmo_1b", "minicpm_2b",
            "gemma2_27b", "deepseek_moe_16b", "deepseek_v2_lite_16b"]
# (K step, most k per split) of each kernel, from csrc/lowrank_linear.cu:
# D_KS / D_KMAX (fp32 decode), P_BK (fp32 prefill), T_BK (bf16 mma)
KERNEL_K = {("decode", torch.float32): (16, 512),
            ("prefill", torch.float32): (8, 1 << 30),
            ("decode", torch.bfloat16): (32, 1 << 30),
            ("prefill", torch.bfloat16): (32, 1 << 30)}
TILE_CODE = {("decode", torch.float32): 16, ("prefill", torch.float32): 64,
             ("decode", torch.bfloat16): 16, ("prefill", torch.bfloat16): 128}


def plan_ok(k, splits, kchunk, step, kmax):
    """Mirror of ``plan_ok`` in csrc/lowrank_linear.cu."""
    return (splits >= 1 and kchunk > 0 and kchunk % step == 0
            and kchunk <= kmax and (splits - 1) * kchunk < k
            and splits * kchunk >= k)


def projections(cfg):
    """(d_in, d_out) of every Linear of one layer kind that lowrank_linear
    runs once factored: attention, the dense FFN, the shared experts."""
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.kv_lora_rank:               # MLA: wq, w_dkv, wo
        out = [(d, cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
               (d, cfg.kv_lora_rank), (cfg.n_heads * cfg.v_head_dim, d)]
    else:
        out = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
               (cfg.n_heads * hd, d)]
    ffs = [cfg.d_ff]
    if cfg.uses_moe:
        ffs = ([cfg.d_ff] if cfg.first_k_dense else []) + \
              [cfg.moe.num_shared * cfg.moe.d_ff_expert]
    for f in ffs:
        out += [(d, f), (f, d)]
    return out


def _shapes():
    for name in FAMILIES:
        cfg = get_config(name)
        for ratio in (0.6, 0.3):
            for d_in, d_out in projections(cfg):
                r = min(rank_for_ratio(d_in, d_out, ratio), d_in, d_out)
                yield pytest.param(d_in, r, d_out, id=f"{name}-{ratio}-{d_in}x{d_out}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,r,d_out", list(_shapes()))
def test_lowrank_plans_fit_the_kernels(d_in, r, d_out, dtype):
    for m in (1, 8, 16, 40, 256, 4608):
        p1, p2 = tll.plan(m, d_in, r, d_out, dtype)
        for p, (n, k) in ((p1, (r, d_in)), (p2, (d_out, r))):
            step, kmax = KERNEL_K[(p.kind, dtype)]
            assert plan_ok(k, p.splits, p.kchunk, step, kmax), (m, p)
            assert p.tile == TILE_CODE[(p.kind, dtype)]
            assert p.tiles_m <= 65535 and p.splits <= 65535
            assert (p.m, p.n, p.k) == (m, n, k)
        work_n, t_n, counters = tll.scratch_layout(m, d_in, r, d_out, dtype)
        assert work_n >= max(p1.workspace, p2.workspace) and work_n % 4 == 0
        assert 4 * t_n >= m * r * dtype.itemsize
        assert counters >= max(p1.counters, p2.counters)
        key = (torch.device("cpu"), -m)
        try:
            tll.reserve_scratch(key[0], key[1], work_n + t_n, counters)
            work, cnt = tll.call_scratch(key[0], key[1], work_n + t_n, counters)
            assert work.numel() >= work_n + t_n and cnt.numel() >= counters
        finally:
            tll.release_scratch(*key)


def test_gemma2_down_takes_more_splits_than_aimed_for():
    """K 36864 at fp32 decode: 72 splits of 512 k, past the 64 the planner
    aims under (the comment on ``TILES`` says so)."""
    cfg = get_config("gemma2_27b")
    r = rank_for_ratio(cfg.d_ff, cfg.d_model, 0.6)
    p1, _ = tll.plan(8, cfg.d_ff, r, cfg.d_model, torch.float32)
    s_aim = tll.TILES[("decode", torch.float32)][5]
    assert p1.splits == 72 > s_aim and p1.kchunk == 512
    assert p1.splits * 16 * 128 * 4 == 589824          # partials per tile
