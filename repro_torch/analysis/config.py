"""tracecheck configuration for the port: its contracts, as data
(counterpart of ``repro.analysis.config``).

One :class:`Config` says which rule applies where (scopes by directory),
which functions start the code that runs inside the device-resident
rounds and the CUDA-graph bodies (the port's "jit-reachable" roots),
which functions are the sanctioned heads of the draw chain and the
sanctioned sync points, and which modules the clustering product never
imports (the LM quarantine).  ``default_config()`` encodes the shipped
tree's contracts; tests build narrower configs for the fixture corpus.

The scope patterns are directory or file suffixes matched against posix
paths: ``"core/"`` matches any file under a ``core`` directory component
(so ``tests/fixtures/tracecheck_torch/bad/core/`` lands in the same
scopes as ``repro_torch/core/``), ``"core/engine.py"`` matches that file
wherever its tree is rooted, and ``"*"`` matches everything.

This module is stdlib only: it imports neither torch nor jax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["Config", "default_config", "path_in_scope", "LIVE_IN_PORT",
           "LM_QUARANTINE"]


def path_in_scope(path: str, patterns: Tuple[str, ...]) -> bool:
    """True if ``path`` (posix-ish) matches any scope pattern."""
    p = "/" + path.replace("\\", "/").lstrip("/")
    for pat in patterns:
        if pat == "*":
            return True
        if pat.endswith("/"):
            if ("/" + pat) in (p + "/"):
                return True
        elif p.endswith("/" + pat):
            return True
    return False


# The JAX package's LM scaffolding (``repro.analysis.config``'s
# ``LM_QUARANTINE``) under the port's names.
_JAX_QUARANTINE: Tuple[str, ...] = (
    "repro_torch.configs",
    "repro_torch.configs.arctic_480b",
    "repro_torch.configs.base",
    "repro_torch.configs.falcon_mamba_7b",
    "repro_torch.configs.gemma3_12b",
    "repro_torch.configs.granite_8b",
    "repro_torch.configs.llama4_scout_17b",
    "repro_torch.configs.mistral_nemo_12b",
    "repro_torch.configs.musicgen_large",
    "repro_torch.configs.phi3_vision_4_2b",
    "repro_torch.configs.qwen3_1_7b",
    "repro_torch.configs.zamba2_2_7b",
    "repro_torch.distributed",
    "repro_torch.distributed.compression",
    "repro_torch.distributed.pipeline",
    "repro_torch.distributed.sharding",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.launch.serve",
    "repro_torch.launch.specs",
    "repro_torch.launch.train",
    "repro_torch.models",
    "repro_torch.models.layers",
    "repro_torch.models.model",
    "repro_torch.models.moe",
    "repro_torch.models.ssm",
    "repro_torch.runtime.elastic",
    "repro_torch.runtime.fault",
    "repro_torch.serve.lm",
    "repro_torch.train",
    "repro_torch.train.compressed",
    "repro_torch.train.data",
    "repro_torch.train.optimizer",
    "repro_torch.train.train_step",
)

# Of those, the modules the port's product does import: the service's
# restore onto a mesh (``serve.service``) gathers DTensor leaves through
# ``distributed.sharding.to_local_full``, which loads the package front and
# with it ``distributed.compression``.
LIVE_IN_PORT: Tuple[str, ...] = (
    "repro_torch.distributed",
    "repro_torch.distributed.compression",
    "repro_torch.distributed.sharding",
)

# Modules kept in the tree although the clustering product never imports
# them: the JAX package's quarantine less ``LIVE_IN_PORT``, then the
# port's own, each with its reason.  They are reachable only from their
# own tests and scripts ("test-only" in the import report).  Anything
# else that turns up dormant is an error: the list is exact in both
# directions.
LM_QUARANTINE: Tuple[str, ...] = tuple(
    m for m in _JAX_QUARANTINE if m not in LIVE_IN_PORT) + (
    # The LM curation driver (``python -m repro_torch.train.curated``):
    # the JAX package has it as an example script, outside its package.
    "repro_torch.train.curated",
    # The launch package's front: its modules above are LM launchers.
    "repro_torch.launch",
    # JAX-to-port conversion of draws, fitted state and LM weights: the
    # parity tests' tool, which the product never calls.
    "repro_torch.convert",
    # The kernels' own references, kept for the card's kernel tests.
    "repro_torch.kernels.ref",
)


@dataclasses.dataclass
class Config:
    """Rule scopes and the port's analysis hints (module docstring)."""

    # rule id -> path patterns the rule runs on
    scopes: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    # path patterns skipped entirely
    exclude: Tuple[str, ...] = ("__pycache__/",)

    # Qualified names (dotted suffixes) whose bodies run inside a
    # device-resident round or a CUDA-graph capture: the roots of the
    # reachability closure, besides the *StatsBackend methods, the
    # functions handed to ``trace_takers`` and ``all_roots_paths``.
    round_roots: Tuple[str, ...] = ()
    # Callables (simple names) whose function-valued arguments run inside
    # the rounds (the searches' stats_fn / exact_fn / count_fn).
    extra_trace_takers: Tuple[str, ...] = ()
    # Files whose module-level functions are ALL reachable public surface
    # (the kernel wrappers, called from the rounds of other modules) ...
    all_roots_paths: Tuple[str, ...] = ()
    # ... except these qualified names (host-side hooks).
    host_boundary: Tuple[str, ...] = ()

    # TRC001: the sanctioned sync points.  A call to one is the
    # sanctioned read; their own bodies and the ``with`` blocks of the
    # context managers among them are exempt.
    sanctioned_syncs: Tuple[str, ...] = ()

    # TRC003: qualified names (a dotted window of the function's
    # qualname: a function, a method or a class) allowed to start a draw
    # chain, and files whose every function is part of the chain.
    sanctioned_chain_heads: Tuple[str, ...] = ()
    sanctioned_chain_paths: Tuple[str, ...] = ()

    # TRC005 sub-scopes (the rule id shares one suppression token).
    trc005_vmap: Tuple[str, ...] = ()
    trc005_setinf: Tuple[str, ...] = ()
    trc005_f32: Tuple[str, ...] = ()
    trc005_tf32: Tuple[str, ...] = ()

    # The import report: product roots and the documented dormant modules.
    product_roots: Tuple[str, ...] = ()
    quarantine: Tuple[str, ...] = ()

    def rule_scope(self, rule_id: str) -> Tuple[str, ...]:
        return self.scopes.get(rule_id, ())


def default_config() -> Config:
    """The shipped tree's contract."""
    return Config(
        scopes={
            # Host syncs in round-reachable engine and kernel code.
            "TRC001": ("core/", "kernels/"),
            # Python for/while in round-reachable code: a launch a trip.
            "TRC002": ("core/", "kernels/"),
            # Draws outside the sanctioned chain heads.
            "TRC003": ("core/", "kernels/", "serve/"),
            # Collectives inside stats backends (anywhere).
            "TRC004": ("*",),
            # Parity breakers: each sub-check carries its own scope, and
            # the float32 precision check covers the whole tree.
            "TRC005": ("*",),
        },
        round_roots=(
            # The device-resident searches' rounds.
            "_Search.round", "_LaneSearch.round",
            # The bodies that predict runs eagerly and captures in its
            # CUDA graphs (its ``_capture`` runs them under
            # ``torch.cuda.graph``).
            "_predict_body", "_assign_body",
        ),
        extra_trace_takers=(
            # The searches run their stats_fn / exact_fn / count_fn in
            # every round.
            "device_search", "lane_search", "adaptive_search",
        ),
        all_roots_paths=("kernels/",),
        host_boundary=(
            # The build of the kernel library: nvcc, the digest, the
            # loader, the C status check.
            "nvcc_path", "_sources", "_digest", "build.py:build",
            "build.py:lib", "build.py:check",
            # The launch counters: host bookkeeping read by the drivers
            # and the smoke script, never a launch.
            "launch_counts", "reset_launch_counts", "add_launches",
            # The bin scratch's size: host arithmetic on the launch's
            # shape before the launch.
            "_scratch_floats",
        ),
        sanctioned_syncs=("host_read", "host_stage", "phase_sync",
                          "syncs_allowed"),
        sanctioned_chain_heads=(
            # The single fit's chain head: the JAX threefry chain for a
            # seed.
            "from_seed",
            # The sharded fit's (seed ^ phase tag) chain head.
            "_phase_key",
            # The serving reservoir: one fixed key, draws fold in the
            # stream index.
            "Reservoir.__init__",
            # A seeded torch.Generator as a layout source: kept for the
            # tests that replay other draws until ROADMAP A19 deletes it.
            "from_generator", "GeneratorLayouts",
        ),
        sanctioned_chain_paths=(
            # The threefry functions are the chain itself.
            "core/threefry.py",
        ),
        trc005_vmap=("core/banditpam.py", "core/batch.py"),
        trc005_setinf=("core/engine.py", "kernels/"),
        trc005_f32=("serve/drift.py", "runtime/checkpoint.py"),
        trc005_tf32=("*",),
        product_roots=(
            "repro_torch.api", "repro_torch.serve",
            # The analysis package and its entry points: the CLIs and the
            # guard are imported by name, not through the package front.
            "repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.guard", "repro_torch.analysis.imports",
            "repro_torch.analysis.graph",
            "repro_torch.analysis.graph.__main__",
        ),
        quarantine=LM_QUARANTINE,
    )
