"""chip_smoke.py's phases at small sizes on the CPU, its tolerance check
(a TF32-sized error must fail it), and its refusal of a non-GPU
platform.  The phases at real size run on the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

_SMALL = {
    "banded": lambda: cs.phases_banded(m=2000, half=5, k=4),
    "stencil": lambda: cs.phases_stencil(n3=8, n2=20),
    "uniform": lambda: cs.phases_uniform(m=3000, deg=5),
    "rmat": lambda: cs.phases_rmat(n=1024, deg=8),
    "data": lambda: cs.phases_data(["fem2d_128", "rmat_32k"]),
    "spmm_uniform": lambda: cs.phases_spmm_uniform(m=500, deg=5, k=8),
    "spgemm": lambda: cs.phases_spgemm(m=500, nnz=3000),
    "sptrsv": lambda: cs.phases_sptrsv(m=2048, block=64, deg=4),
    "add_transpose": lambda: cs.phases_add_transpose(m=1000, deg=5),
    "bsr16x16": lambda: cs.phases_bsr((16, 16), mb=32, nb=32,
                                      per_row=4, k=8),
    "bsr8x128": lambda: cs.phases_bsr((8, 128), mb=64, nb=16,
                                      per_row=4, k=8),
    "grad": lambda: cs.phases_grad(m=500, deg=5),
    "four_cards": lambda: cs.phases_four(
        p=4, band_m=4 * 1024, half=5, m=3000, deg=5, spmm_m=500, k=8,
        gemm_m=500, gemm_nnz=3000, trsv_m=1024),
}


@pytest.mark.parametrize("group", sorted(_SMALL))
def test_phase_group_small_on_cpu(group):
    recs = [cs.run_phase(ph, reps=1) for ph in _SMALL[group]()]
    assert recs
    for rec in recs:
        assert rec["ok"], rec
        assert rec["jaxpr_forbidden"] == []
        assert rec["max_err_over_tol"] <= 1.0
        assert rec["steady_s"] > 0 and rec["bytes"] > 0


def test_single_card_list_covers_every_group():
    assert len(cs.SINGLE_CARD) == len(_SMALL) - 1


def test_tf32_sized_error_fails_the_check():
    """A 1e-3 relative error (what TF32 products give) must fail the
    64 eps (|A| |x|) tolerance; a one-ulp error must pass it."""
    from spblas_tpu.utils.generate import generate_csr
    a = generate_csr(300, 300, 3000, seed=0)
    x = np.random.default_rng(1).uniform(0.5, 1.0, 300).astype(
        np.float32)
    check = cs.check_product(cs.to_scipy(a), x, cs.eps_of(np.float32))
    exact = cs.to_scipy(a) @ x.astype(np.float64)
    assert check(exact.astype(np.float32)) <= 1.0
    assert check(exact * (1 + 1e-3)) > 1.0


def test_err_ratio_shape_mismatch_and_exact_zero():
    assert cs.err_ratio(np.zeros(3), np.zeros(4), np.ones(4), 1e-7) == \
        float("inf")
    assert cs.err_ratio(np.zeros(3), np.zeros(3), np.zeros(3), 1e-7) == 0


def test_sparse_check_rejects_wrong_structure():
    import scipy.sparse as sps
    ref = sps.csr_matrix(np.array([[1.0, 0.0], [0.0, 2.0]]))
    got = sps.csr_matrix(np.array([[1.0, 3.0], [0.0, 2.0]]))
    assert cs.sparse_err_ratio(ref, ref, abs(ref), 1e-7) == 0
    assert cs.sparse_err_ratio(got, ref, abs(ref), 1e-7) == float("inf")


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_script_refuses_cpu_and_prints_no_result():
    out = _run_script(cs.ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_script_alone_fails(tmp_path):
    import shutil
    shutil.copy(os.path.join(cs.ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_phases_small_on_gpu(gpu):
    """The same small phases compiled for the card."""
    for group in ("banded", "uniform", "spgemm", "bsr16x16", "grad"):
        for ph in _SMALL[group]():
            rec = cs.run_phase(ph, reps=1)
            assert rec["ok"], rec
    assert json.loads(json.dumps(rec))["plan"]
