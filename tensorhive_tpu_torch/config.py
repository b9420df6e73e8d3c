"""Serving configuration of the port: a copy of the ``GenerationConfig``
fields of ``tensorhive_tpu/config.py`` (``[generation_service]``) that the
ported engine and its daemon read, with the JAX package's defaults, plus a
small :class:`Config` holding them beside the ``[accounting]`` and
``[profiling]`` sections and the config directory (crash dumps, profiles).
There is no TOML loader: callers build a :class:`Config` (or take the
defaults of :func:`get_config`).

The prefix cache with chunked prefill (``prefix_cache``; ``auto`` = on
for the paged layout), the contiguous layout (``paged=False``), the
speculative lane (``speculative``; ``auto`` = on where the engine runs on
the card, off on the CPU), host KV tiering (``host_kv_bytes`` > 0, paged
int8 with the prefix cache) and per-request deadlines
(``default_deadline_s``, ``max_deadline_s``) are served. The serving mesh
(``mesh_dp``/``mesh_tp`` > 1) is accepted here and refused by
``build_engine`` with a "not yet ported" error. ``checkpoint_path`` names
the directory of the port's own ``train.save_checkpoint`` files
(``step_<n>.pt``); ``tools/torch_convert_checkpoint.py`` writes them from
an orbax directory of the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

DEFAULT_CONFIG_DIR = "~/.config/tpuhive"


@dataclasses.dataclass
class GenerationConfig:
    preset: str = "tiny"
    slots: int = 8                   # the decode batch size
    max_len: int = 0                 # 0 = the preset's max_seq_len
    mesh_dp: int = 1
    mesh_tp: int = 1
    checkpoint_path: str = ""        # directory of train.save_checkpoint
                                     # files (step_<n>.pt); "" serves random
                                     # init params. A missing, unreadable or
                                     # mis-shaped checkpoint leaves the
                                     # daemon up with no engine and the
                                     # reason published
    paged: bool = True
    page_size: int = 16              # tokens per KV page
    kv_pages: int = 0                # 0 = slots * ceil(max_len / page_size)
                                     # bytes' worth of pages
    paged_kernel: str = "auto"       # auto|on = the CUDA paged-attention
                                     # kernel; off is refused
    kv_quant: str = "auto"           # int8 pages with per-(page, kv_head)
                                     # scales; auto = on for the paged layout
    prefix_cache: str = "auto"      # radix prefix cache + chunked prefill;
                                     # auto = on for the paged layout
    prefix_min_tokens: int = 32      # shortest prefix match worth sharing
    prefill_chunk_tokens: int = 256  # prefill positions per chunk (per
                                     # tick); 0 = one chunk per prompt
    host_kv_bytes: int = 0           # host-RAM budget for demoted int8
                                     # pages; 0 = no tier
    speculative: str = "auto"        # draft-model speculative decoding:
                                     # auto = on where the engine runs on
                                     # the card, off on the CPU. Greedy
                                     # output is token-identical to the
                                     # non-speculative engine's either way
    draft_preset: str = ""           # draft model preset (must share the
                                     # vocab); "" = self-draft from the
                                     # target's first draft_layers layers
    draft_layers: int = 0            # self-draft depth (0 = half the
                                     # target's layers, min 1)
    spec_tokens: int = 4             # draft tokens proposed + verified in
                                     # one batched pass per tick
    queue_depth: int = 32
    max_new_tokens: int = 128        # per-request cap
    top_k: int = 0                   # 0 = no top-k sampling filter
    eos_token: int = -1              # -1 = no EOS, run to max_new_tokens
    max_concurrent_per_user: int = 4  # 0 = unlimited
    default_deadline_s: float = 120.0  # per-request wall budget (queue +
                                       # prefill + decode) when the caller
                                       # gives none; 0 = no deadline
    max_deadline_s: float = 600.0    # ceiling for per-request overrides
    interval_s: float = 0.02         # pump tick; do_run budgets inside it
    queue_wait_slo_s: float = 1.0    # p95 admission-queue wait budget (the
                                     # tenant dominance signal's gate)
    request_ledger_size: int = 256   # bounded per-request ledger ring
    # -- the supervisor: transient retries, the restart budget, the drain
    transient_retries: int = 3       # transient pump failures retried
                                     # against the same engine per incident
                                     # before the fatal path
    transient_backoff_s: float = 0.05  # base backoff between transient
                                       # retries (doubles per retry)
    restart_budget: int = 3          # engine rebuilds allowed within
                                     # restart_window_s before the
                                     # crash-loop breaker trips
    restart_window_s: float = 60.0   # sliding window the budget counts in
    restart_cooldown_s: float = 30.0  # breaker cooldown before one probe
                                      # rebuild is allowed
    drain_timeout_s: float = 10.0    # shutdown drain bound: in-flight
                                     # requests get this long to finish
                                     # before they are failed fast
    # -- the flight recorder: per-tick black box + crash dumps on fatal
    flight_recorder: bool = True     # false = no ring, no dumps, step()
                                     # unrecorded
    flightrec_ticks: int = 512       # bounded per-tick ring capacity
    flightrec_dumps: int = 8         # crash dumps kept under
                                     # {config_dir}/flightrec


@dataclasses.dataclass
class AccountingConfig:
    """Per-tenant resource attribution (``[accounting]``). Disabled = the
    meter is never built and the engine takes its meter-less path."""
    enabled: bool = True
    top_k_tenants: int = 8           # tenants exported by name; the rest
                                     # collapse into the 'other' bucket
    window_s: float = 3600.0         # default rollup and dominance window
    dominance_share: float = 0.5     # dominance threshold (alerting reads
                                     # it; kept for the section's shape)


@dataclasses.dataclass
class ProfilingConfig:
    """On-demand device profiling (``[profiling]``). Disabled by default:
    the profiler is process-wide and captures write artifacts to disk."""
    enabled: bool = False
    artifact_dir: str = "{config_dir}/profiles"
    max_duration_s: float = 10.0     # per-capture ceiling (absolute cap 60)
    default_duration_s: float = 1.0  # when the caller gives no duration


@dataclasses.dataclass
class Config:
    """The sections of the JAX package's ``Config`` that the port's serving
    daemon reads."""
    config_dir: Path = Path(os.path.expanduser(DEFAULT_CONFIG_DIR))
    generation: GenerationConfig = dataclasses.field(
        default_factory=GenerationConfig)
    accounting: AccountingConfig = dataclasses.field(
        default_factory=AccountingConfig)
    profiling: ProfilingConfig = dataclasses.field(
        default_factory=ProfilingConfig)

    @property
    def flightrec_dir(self) -> Path:
        """Where the supervisor writes flight-recorder crash dumps."""
        return Path(self.config_dir) / "flightrec"

    @property
    def profile_artifact_dir(self) -> Path:
        return Path(self.profiling.artifact_dir.format(
            config_dir=str(self.config_dir)))


_config: Optional[Config] = None


def get_config() -> Config:
    """The process-wide config (defaults until :func:`set_config`)."""
    global _config
    if _config is None:
        _config = Config()
    return _config


def set_config(config: Config) -> None:
    global _config
    _config = config


def reset_config() -> None:
    global _config
    _config = None
