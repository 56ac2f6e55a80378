"""The platform module's answers, the compile-cache rule, and the chip
smoke check's kernel-parity phase at tiny widths on the CPU."""

import os

import jax
import numpy as np
import pytest

from bfir_tpu.utils import platform

# (question, answer on the CPU, answer on the GPU)
_CHOICES = [
    ("is_cpu", True, False),
    ("pallas_interpret", True, False),
    ("corr_mac_route", "xla", "triton"),
    ("bulk_nu_engine", "split", "gbatch"),
    ("default_tail_store", "float32", "int24"),
]


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("question,on_cpu,on_gpu", _CHOICES,
                         ids=[c[0] for c in _CHOICES])
def test_platform_choices(monkeypatch, backend, question, on_cpu, on_gpu):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    fn = getattr(platform, question)
    got = fn("nonuniform") if question == "default_tail_store" else fn()
    assert got == (on_cpu if backend == "cpu" else on_gpu)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_platform_reads_a_device(backend):
    """A device's own platform decides (a CPU mesh under a GPU default
    backend, as in a virtual-device rehearsal)."""

    class Dev:
        platform = backend

    assert platform.backend(Dev()) == backend
    assert platform.is_cpu(Dev()) == (backend == "cpu")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is configured;
    without it the cache is a fixed .jax_cache/ in the checkout."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert platform.enable_compile_cache() == str(tmp_path / "c")
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = platform.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", got)]
        # the path is fixed: a second call names the same directory
        assert platform.enable_compile_cache() == got
        assert platform.enable_compile_cache(str(tmp_path)) == str(
            tmp_path / ".jax_cache")


def test_session_auto_engine_follows_platform(monkeypatch, tmp_path):
    """The streaming session asks the platform module: on the GPU a
    flagship-length filter (128 partitions) resolves to nonuniform."""
    from bfir_tpu.core.spec import EngineConfig
    from bfir_tpu.engine.cache import ArtifactCache
    from bfir_tpu.engine.session import StreamProcessor

    sp = StreamProcessor(EngineConfig(), ArtifactCache(str(tmp_path)))
    sp.n_partitions = 128
    assert sp._resolve_engine_mode() == "complex"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sp._resolve_engine_mode() == "nonuniform"
    assert sp._resolve_nu_tail_store("nonuniform") == "int24"


_PARITY = ["mac_hc head f32", "mac_hc head shared-coeff", "mac_hc tail f32",
           "mac_hc tail int24", "mac band (split tail, band 0)",
           "mac band (split tail, band 1)", "mac_reference split planes",
           "corr_mac xla gbatch head", "corr_mac xla gbatch tail",
           "corr_mac triton gbatch head", "corr_mac triton gbatch tail",
           "rfft_split_hc n=256", "irfft_hc_tail n=256",
           "rfft_split_hc n=1024", "irfft_hc_tail n=1024"]


@pytest.fixture(scope="module")
def parity_results():
    import chip_smoke

    return {name: (err, tol) for name, err, tol, _ in chip_smoke.kernel_parity(
        c=4, p_head=4, hp_head=128, p_tail=3, hp_tail=512, gbatch_blocks=8)}


@pytest.mark.parametrize("name", _PARITY)
def test_chip_smoke_parity_tiny(parity_results, name):
    """chip_smoke.py phase (b) on the CPU at tiny widths: every check is
    present and within its stated tolerance."""
    err, tol = parity_results[name]
    assert np.isfinite(err) and err <= tol, (name, err, tol)
