"""bfir_tpu: a partitioned-convolution audio engine on JAX accelerators.

A framework with the capabilities of vsu/foo-dsp-bfir (a foobar2000 DSP
plugin wrapping the BruteFIR partitioned FFT convolution engine), built on
JAX/XLA for the compute path (an NVIDIA GPU is the target accelerator) and
`jax.sharding` meshes for multi-device scale.

Layer map (mirrors SURVEY.md §1):

- ``core``     — typed specs + the partitioned overlap-save convolver
                 (reference: ``brutefir/fftw_convolver.{cpp,hpp}``,
                 ``brutefir/brutefir.{cpp,hpp}``)
- ``ops``      — FIR design, equalizer, dither, sample-format codecs, delay,
                 resampling, noise probes (reference: ``brutefir/firwindow.c``,
                 ``equalizer.cpp``, ``dither.cpp``, ``raw2real.cpp``,
                 ``real2raw.cpp``, ``delay.cpp``, ``buffer.cpp``)
- ``engine``   — streaming session, filter-chain composition, artifact cache
                 (reference: ``foo_dsp_bfir/foo_dsp_bfir.cpp``,
                 ``brutefir/preprocessor.cpp``, ``brutefir/bfir_path.cpp``)
- ``parallel`` — device mesh runtime: sharded engine state, partition psum,
                 ring ppermute streaming (new work; the reference is
                 single-threaded C++ — SURVEY.md §2 "Parallelism")
- ``kernels``  — the streaming steps' spectrum MACs and the df64 engine
- ``io``       — WAV file IO (reference: ``libsndfile`` binary + ``buffer.cpp``)
- ``cli``      — TCP line-protocol control server (reference: ``cli_server/``)
"""

__version__ = "0.1.0"

from bfir_tpu.core.spec import (  # noqa: F401
    SampleFormat,
    FilterSpec,
    StreamSpec,
    EqSpec,
    ImpulseFileSpec,
    ChainSpec,
    DelaySpec,
    EngineConfig,
)
