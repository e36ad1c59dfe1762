"""chip_smoke.py on the CPU: its refusal without a GPU, its helpers (cache
directory, nvidia-smi parser, compiled-dot classifier), and every phase
function at tiny sizes against the same oracles it uses on the card."""

import os
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main(argv)
    assert "needs an NVIDIA GPU" in str(exc.value.code)
    # no result line on stdout
    assert '"ok"' not in capsys.readouterr().out


def test_script_exits_nonzero_without_gpu():
    """Run as a script: a fresh process on the CPU backend fails and
    prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


@pytest.mark.parametrize("environ,want", [
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(environ, want):
    assert cs.compile_cache_dir(environ) == want


class _Config:
    def __init__(self):
        self.updates = {}

    def update(self, key, value):
        self.updates[key] = value


class _Jax:
    def __init__(self):
        self.config = _Config()


@pytest.mark.parametrize("set_env", [False, True])
def test_configure_cache(set_env, monkeypatch):
    """Unset: the checkout's .jax_cache/ is configured.  Set: JAX reads the
    variable itself and no other directory is set in code."""
    if set_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fake = _Jax()
    path = cs.configure_cache(fake)
    if set_env:
        assert path == "/elsewhere/cache"
        assert "jax_compilation_cache_dir" not in fake.config.updates
    else:
        assert path == os.path.join(REPO, ".jax_cache")
        assert fake.config.updates["jax_compilation_cache_dir"] == path


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 400.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n",
     [("NVIDIA H100 80GB HBM3", "400.00 W")] * 2),
    ("Some, Card, 350.00 W", [("Some, Card", "350.00 W")]),
    ("", []),
    ("garbage without a comma\n", []),
])
def test_parse_gpu_query(text, want):
    assert cs.parse_gpu_query(text) == want


_HLO_GPU = """\
HloModule jit_f, entry_computation_layout={(s8[64,64]{1,0})->s32[64,64]{1,0}}

%triton_gemm_dot.1_computation (parameter_0: s8[64,64], parameter_1: s16[64,64]) -> s32[64,64] {
  %parameter_0 = s8[64,64]{1,0} parameter(0)
  %parameter_1 = s16[64,64]{1,0} parameter(1)
  ROOT %dot.1 = s32[64,64]{1,0} dot(s8[64,64]{1,0} %parameter_0, s16[64,64]{1,0} %parameter_1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%fused_loop (p0: s32[64,64], p1: s32[64,64]) -> s32[64,64] {
  %p0 = s32[64,64]{1,0} parameter(0)
  %p1 = s32[64,64]{1,0} parameter(1)
  ROOT %dot.2 = s32[64,64]{1,0} dot(s32[64,64]{1,0} %p0, s32[64,64]{1,0} %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main (a: s8[64,64], b: s16[64,64], c: s32[64,64]) -> s32[64,64] {
  %a = s8[64,64]{1,0} parameter(0)
  %b = s16[64,64]{1,0} parameter(1)
  %c = s32[64,64]{1,0} parameter(2)
  %cublas-gemm.1 = (s32[64,64]{1,0}, s8[0]{0}) custom-call(s8[64,64]{1,0} %a, s8[64,64]{1,0} %a), custom_call_target="__cublas$gemm"
  %lt = (s32[64,64]{1,0}, s8[0]{0}) custom-call(s8[64,64]{1,0} %a, s8[64,64]{1,0} %a), custom_call_target="__cublas$lt$matmul"
  %gemm_fusion = s32[64,64]{1,0} fusion(s8[64,64]{1,0} %a, s16[64,64]{1,0} %b), kind=kCustom, calls=%triton_gemm_dot.1_computation, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
  ROOT %loop = s32[64,64]{1,0} fusion(s32[64,64]{1,0} %c, s32[64,64]{1,0} %c), kind=kLoop, calls=%fused_loop
}
"""


def test_dot_routes_classifies_each_dot():
    routes = cs.dot_routes(_HLO_GPU)
    assert sorted(routes) == sorted([
        ("cublas", ("s8", "s8")),
        ("cublaslt", ("s8", "s8")),
        ("triton_gemm", ("s8", "s16")),
        ("other:kLoop", ("s32", "s32")),
    ])
    assert cs.float_dots(routes) == []


def test_dot_routes_nested_triton_gemm_fusion():
    """A kCustom GEMM fusion is a Triton GEMM whatever its backend kind's
    exact spelling."""
    hlo = """\
%gemm_fusion_dot.7_computation (p0: s8[8,8], p1: s8[8,8]) -> s32[8,8] {
  %p0 = s8[8,8]{1,0} parameter(0)
  %p1 = s8[8,8]{1,0} parameter(1)
  ROOT %dot.7 = s32[8,8]{1,0} dot(s8[8,8]{1,0} %p0, s8[8,8]{1,0} %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main (a: s8[8,8]) -> s32[8,8] {
  %a = s8[8,8]{1,0} parameter(0)
  ROOT %gemm_fusion_dot.7 = s32[8,8]{1,0} fusion(s8[8,8]{1,0} %a, s8[8,8]{1,0} %a), kind=kCustom, calls=%gemm_fusion_dot.7_computation, backend_config={"fusion_backend_config":{"kind":"__triton_nested_gemm_fusion"}}
}
"""
    assert cs.dot_routes(hlo) == [("triton_gemm", ("s8", "s8"))]


def test_float_dots_flags_float_operands():
    routes = [("cublas", ("s8", "s8")), ("triton_gemm", ("f32", "f32")),
              ("other:entry", ("bf16", "s8"))]
    assert cs.float_dots(routes) == routes[1:]


def test_dot_routes_on_a_compiled_cpu_program():
    import jax
    import jax.numpy as jnp

    x = jnp.ones((8, 8), jnp.int8)
    text = jax.jit(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.int32)).lower(x, x) \
        .compile().as_text()
    routes = cs.dot_routes(text)
    assert routes and all(r[1] == ("s8", "s8") for r in routes)
    assert all(r[0].startswith("other:") for r in routes)


@pytest.mark.parametrize("text,want", [
    ("... custom_call_target=\"__gpu$xla.gpu.triton\", name=tree_gemm_tiled",
     "tree_gemm_tiled"),
    ("%while.3 = (s32[], s32[4,8]) while(...)", "tree_gemm_scan"),
    ("ROOT %r = s32[4] add(...)", "other"),
])
def test_tree_route(text, want):
    assert cs.tree_route(text) == want


def test_wide_limb_shape_fits_the_cap():
    from qublas_tpu.ops import gemm as G

    m, k, n = cs.wide_limb_shape()
    assert k == 2048 and m == n and m % 256 == 0
    fa, out, kw = cs._wide_formats()
    from qublas_tpu.qformat import mul_merge

    plan = G.exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                        kw["add_formats"], k)
    assert G.limb_dot_plan(fa, fa, out, plan, k, m, n) is not None
    assert G.limb_dot_plan(fa, fa, out, plan, k, m + 256, n + 256) is None


def test_phase_lossless_tiny():
    facts = cs.phase_lossless(n=128, strip=8)
    assert facts["oracle_rows"] == 8 and facts["compile_s"] >= 0


@pytest.mark.parametrize("shapes", [((32, 32, 32),), ((16, 47, 24),),
                                    ((8, 2047, 8),)])
def test_phase_tree_tiny(shapes):
    facts = cs.phase_tree(shapes=shapes, strip=8)
    (stats,) = facts.values()
    assert stats["route"] == "tree_gemm_scan"


def test_phase_tree_rejects_a_wrong_route():
    with pytest.raises(AssertionError, match="expected tree_gemm_tiled"):
        cs.phase_tree(shapes=((8, 8, 8),), strip=2, expect="tree_gemm_tiled")


def test_phase_wide_tiny():
    facts = cs.phase_wide(limb_shape=(8, 64, 8), cgemm_n=32, strip=2,
                          strip_cols=4)
    assert facts["limb_40x40"]["shape"] == [8, 64, 8]
    assert facts["cgemul_tf_int8"]["shape"] == [32, 32, 32]


def test_phase_four_tiny():
    """The --four phase on four virtual CPU devices."""
    import jax

    facts = cs.phase_four(jax.devices()[:4], lossless_n=32, tree_n=16,
                          limb_shape=(8, 64, 8), cgemm_n=16, reduce_n=256)
    assert "mn@2x2" in facts and "k_tree@1x4" in facts
    assert "sharded_qreduce_k@1x4" in facts


@pytest.mark.parametrize("result,ok", [((0, 3), True), ((2, 0), False)])
def test_phase_differential_reports_failed_routes(result, ok, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import device_differential

    monkeypatch.setattr(device_differential, "run_all", lambda: result)
    if ok:
        assert cs.phase_differential()["host_routed_skips"] == 3
    else:
        with pytest.raises(AssertionError, match="2 differential routes"):
            cs.phase_differential()


def test_run_phases_reports_failure(capsys):
    def bad():
        raise AssertionError("mismatch")

    failed = cs.run_phases([("good", lambda: {"route": "x"}), ("bad", bad)])
    assert failed == ["bad"]
    out = capsys.readouterr().out
    assert '"phase": "good", "status": "ok"' in out
    assert '"status": "FAILED"' in out and "mismatch" in out
