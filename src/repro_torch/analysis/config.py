"""Port-specific scoping for the rule packs.

Paths are posix-style, relative to the scan root (scanning
``src/repro_torch`` makes the oracle ``core/oracle.py``; ``chip_smoke.py``
scanned beside it keeps its file name).  The fixture trees the tests
build mirror that layout, so scopes apply there unchanged.
"""
from __future__ import annotations

import re

# -- determinism pack --------------------------------------------------------

# Directories whose numerics must be run-to-run deterministic: the oracle
# formulas, the exploration engine, the kernel packages and the synthetic
# data pipelines.  (launch/, serve/, train/ may legitimately read clocks.)
DETERMINISM_DIRS = ("core/", "explore/", "kernels/", "data/")

# np.random factories that carry explicit seed state (everything else on
# np.random is the hidden module-global generator).
SEEDED_RNG_FACTORIES = frozenset({
    "RandomState", "default_rng", "Generator", "SeedSequence",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
})

# torch draws from its hidden default generator unless given generator=
# (the *_like forms take none, so they always do).
TORCH_RNG_CALLS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
})
TORCH_RNG_METHODS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
})

# Wall-clock reads (date/time-of-day).  Monotonic benchmarking clocks
# (perf_counter / monotonic) are deliberately NOT listed: throughput
# metadata is allowed, nondeterministic *inputs* are not.
WALL_CLOCK_CALLS = frozenset({
    ("time", "time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
})

# Seed-consuming constructors whose arguments must come from
# repro_torch.core.seeding.derive_seed rather than ad-hoc arithmetic.
SEED_SINKS = frozenset({"RandomState", "default_rng", "SeedSequence",
                        "manual_seed"})
SEED_DERIVER = "derive_seed"

# -- exactness pack ----------------------------------------------------------

# Modules under the parity_max_rel_err == 0.0 contract: the batch oracle
# formulas, the dataflow model, the fused device programs, the
# polynomial models' fixed-order sum (P1), and exact.py, the one home of
# torch.div.
PARITY_CRITICAL = frozenset({
    "core/oracle.py", "core/dataflow.py", "explore/device.py",
    "core/ppa.py", "core/exact.py",
})

# float32 by design, and bit-equal to the reference (AdamW, sgd_update):
# held to the division, fused multiply-add and tie rules (EXA005-EXA007).
BIT_EQUAL_F32 = frozenset({"train/optimizer.py"})

# The sanctioned division (exact.div / exact.floor_div live here).
EXACT_DIVISION_MODULE = "core/exact.py"

# Functions whose callees (transitively, across modules) are array
# context: the batch oracle's entry points ...
ARRAY_ROOTS = {
    "core/oracle.py": frozenset({"characterize_batch",
                                 "characterize_joint_dedup"}),
}
# ... and the builders of the device programs: the nested functions they
# return are the per-chunk programs the backends run (and a CUDA graph
# would capture), so everything they reach is a device program.
DEVICE_PROGRAM_BUILDERS = {
    "explore/device.py": frozenset({"make_eval_fn", "make_joint_fn"}),
}

# Annotations that make a function array context on their own.
TENSOR_ANNOTATIONS = frozenset({("torch", "Tensor"), ("Tensor",)})

# Calls whose value is a tensor wherever they stand, so that arithmetic
# and methods on it are array context even in an unannotated host
# function: torch's constructors, the host-to-device copy and ``.to``.
TENSOR_CONSTRUCTORS = frozenset({
    "tensor", "as_tensor", "from_numpy", "scalar_tensor", "zeros", "ones",
    "empty", "full", "arange", "linspace", "logspace", "eye", "zeros_like",
    "ones_like", "empty_like", "full_like", "stack", "cat", "where",
})
TENSOR_TRANSFERS = frozenset({"h2d"})
TENSOR_CASTS = frozenset({"to"})
# methods of a tensor whose value is a host number, list or array
HOST_VALUE_METHODS = frozenset({"item", "tolist", "numpy"})

# Host modules whose functions are the libm / numpy reference itself.
HOST_MODULES = frozenset({"np", "numpy", "math", "cmath", "struct"})

# dtypes and casts off float64 (EXA001)
LOW_PRECISION_DTYPES = frozenset({"float32", "float", "half", "float16",
                                  "bfloat16"})
LOW_PRECISION_CASTS = frozenset({"float", "half", "bfloat16"})
LOW_PRECISION_STRINGS = frozenset({"float32", "float16", "bfloat16"})

# Ops whose device result is not guaranteed bit-identical to libm/numpy:
# these must be host-precomputed on the exact path (see
# repro_torch.core.oracle.batch_inputs) or carry a justified suppression.
# sqrt and log2 are listed: the probe finds torch's sqrt and CUDA's
# ceil(log2(words)) off numpy's bits (F2, F6).
DIVERGENT_OPS = frozenset({
    "log", "log2", "log10", "log1p", "exp", "exp2", "expm1",
    "power", "pow", "float_power", "tanh", "sinh", "cosh",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2",
    "asin", "acos", "atan", "atan2",
    "erf", "erfc", "cbrt", "sigmoid", "softmax", "log_softmax",
    "logsumexp", "sqrt", "rsqrt",
})

# Reductions/contractions whose accumulation order the device library
# picks (and may change by shape, device or version).
REASSOCIATING_CALLS = frozenset({
    "sum", "mean", "prod", "matmul", "mm", "bmm", "einsum", "tensordot",
    "dot",
})
REASSOCIATING_METHODS = frozenset({"sum", "mean", "prod"})

# Division forms (EXA005): on CUDA a Python-number or CPU-scalar divisor
# becomes a multiply by its reciprocal, and ``float / tensor`` runs as
# reciprocal-then-multiply everywhere (F1, F3).
DIVISION_CALLS = frozenset({"div", "divide", "true_divide", "floor_divide"})
RECIPROCAL = "reciprocal"
SCALAR_TENSOR_FACTORIES = frozenset({"tensor", "scalar_tensor",
                                     "as_tensor"})

# Forms that contract a multiply and an add into one rounding, or pick
# their own order of operations (EXA006, F4).
FUSED_OPS = frozenset({"addcmul", "addcdiv", "lerp", "addmm", "addmv",
                       "addbmm", "baddbmm", "addr"})
FUSING_NAMESPACES = (("torch", "optim"), ("torch", "compile"),
                     ("torch", "jit", "script"), ("torch", "jit", "trace"))

# Tie-breaking left to the library (EXA007, F5).
UNSTABLE_SELECTIONS = frozenset({"topk", "kthvalue"})
SORTS = frozenset({"sort", "argsort"})

# Data-dependent output shapes: the host waits for the device to learn
# the size (EXA008, F7).
HOST_SIZED_OPS = frozenset({"nonzero", "masked_select", "unique",
                            "unique_consecutive", "argwhere"})

# -- graph-purity pack -------------------------------------------------------

# Host coercions that wait for the device inside a device program.
HOST_COERCION_METHODS = frozenset({"item", "tolist", "cpu", "numpy",
                                   "synchronize"})

# -- robustness pack ---------------------------------------------------------

# Directories under the fault-tolerance contract: every exception either
# reaches the resilience layer's retry/demotion accounting or is
# re-raised as a typed ChunkError — never silently swallowed (ROB001).
ROBUSTNESS_DIRS = ("explore/",)

# The one sanctioned device-enumeration call site (ROB003): every other
# module must reach devices through repro_torch.explore.fleet, so the
# fleet's health registry / quarantine cannot be bypassed.  Scanned
# tree-wide.
DEVICE_ENUM_MODULE = "explore/fleet.py"
DEVICE_ENUM_FUNCTION = "visible_devices"
DEVICE_ENUM_CALL = ("torch", "cuda", "device_count")

# The no-fallback rule (ROB004): a plain version runs only because its
# tensor lies on the CPU.
CUDA_PROBE = ("torch", "cuda", "is_available")
EXIT_CALLS = frozenset({("sys", "exit"), ("exit",), ("quit",),
                        ("os", "_exit"), ("os", "abort")})
PLAIN_MODULE_ALIAS = "_ref"
PLAIN_SUFFIX = "_ref"
KERNEL_MODULE_RE = re.compile(r"(?:^|\.)kernels\.[A-Za-z0-9_]+\.(kernel|ops)$")

# -- contract pack -----------------------------------------------------------

KERNEL_PATH_RE = re.compile(r"(?:^|/)kernels/([A-Za-z0-9_]+)/kernel\.py$")
KERNEL_WRAPPER_RE = re.compile(
    r"(?:^|/)kernels/([A-Za-z0-9_]+)/(?:kernel|ops)\.py$")
KERNEL_SIBLINGS = ("ref.py", "ops.py")
KERNEL_SOURCES_DIR = "csrc"
# the port's CPU tests hold it to the reference package of this name
REFERENCE_PACKAGE = "repro"
PORT_TEST_PREFIX = "test_torch_"
GPU_MARKER = "gpu"
STREAMING_MODULE = "explore/streaming.py"
# The guided-search optimizer: every RNG its proposal operators construct
# must be seeded by a *direct* derive_seed(...) call (CON005) — stricter
# than DET005 (which only rejects ad-hoc seed arithmetic), because the
# search bit-identity contract hangs on labelled per-generation streams.
SEARCH_MODULE = "explore/search.py"
REDUCER_BASE = "Reducer"
REDUCER_REQUIRED_METHODS = ("fold", "result")
DEVICE_SPEC_TYPES = frozenset({"ParetoSpec", "TopKSpec", "StatsSpec",
                               "HistSpec"})
