"""The roofline counts against hand counts, and against the tensors a
real plan hands the kernels."""

from __future__ import annotations

import torch

from portbench import roofline as RL


def test_spmv_hand_count():
    # 3 rows, 4 unit entries, d = 3: row pointers 16 B, column ids 16 B,
    # x 36 B read, y 36 B written; an add per entry and coordinate
    assert RL.spmv(3, 3, 4, 3) == (104, 12)
    # weighted: the weights' 16 B more, a multiply-add per entry
    assert RL.spmv(3, 3, 4, 3, weighted=True) == (120, 24)


def test_fused_step_hand_count():
    # n = 4, d = 3, s = 2, K = 2 DIA rows, y_res: x 48 + f_prev 48 + DIA
    # 32 + y_res 48 + row sums 16 + deg + 1 16 + ids 8 read, x' 48 + f 48
    # written; pairs 4 * 2 * 16, DIA 2 * 2 * 4 * 3, y_res's add 12
    assert RL.fused_step(4, 3, 2, 2, True) == (312, 188)
    assert RL.fused_step(4, 3, 2, 0, False) == (4 * 4 * 8 + 8 + 96, 128)


def test_flat_iteration_hand_count():
    # n = 4, 6 entries, d = 3, s = 2: row pointers 20 + ids 24 + x 48 +
    # f_prev 48 + sample ids 8 read, x' 48 + f 48 written; 18 adds, and
    # per vertex 6 + 2 * 16 + 11 + 32
    assert RL.flat_iteration(4, 6, 3, 2) == (244, 18 + 4 * 81)


def test_counts_match_a_real_plan():
    """On a plan of the port (a 6^3 grid: DIA offsets and no residual
    edges; a scale-8 R-MAT graph: residual edges only) the bytes are
    those of the tensors kernels A and D read and write."""
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.utils.params import ForceAtlasParams

    from portbench.program import program_graph
    from portbench.generators import mesh3d, rmat

    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=5)
    cfgs = [(mesh3d, {"side": 6}, dict(dia_min_count=8)),
            (rmat, {"scale": 8, "edge_factor": 8, "a": 0.57, "b": 0.19,
                    "c": 0.19}, {})]
    for gen, cfg, kw in cfgs:
        g = program_graph(gen.build(cfg, 3, "cpu"))
        tfa = TL.prepare_tiled(g, 3, params, **kw)
        n, k, s = g.n, len(tfa.dia_offsets), 5
        x = torch.zeros(n, 3)
        read = (2 * x.numel() + tfa.deg_w_att.numel() + tfa.deg_p1.numel()
                + (tfa.dia_w.numel() if k else 0)
                + (x.numel() if tfa.csr is not None else 0))
        assert RL.fused_step(n, 3, s, k, tfa.csr is not None)[0] == \
            4 * read + 4 * s + 4 * 2 * x.numel()
        if tfa.csr is not None:
            csr = tfa.csr
            assert RL.spmv(n, n, csr.nnz, 3)[0] == 4 * (
                csr.indptr.numel() + csr.col.numel()) + 4 * 2 * x.numel()
        assert gen is rmat or k > 0
