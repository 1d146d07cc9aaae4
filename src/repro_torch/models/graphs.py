"""The decode macro as one CUDA graph of one step, replayed ``n_steps``
times: the port's counterpart of the reference's one-launch ``lax.scan``
macro (``repro/models/model.py:1150``), whose host "never synchronises
at token granularity".

``DecodeGraph`` owns the macro's carry (``model.MacroCarry``) as static
buffers, runs ``model.decode_body`` once eagerly (cuBLAS handles, the
kernels' libraries and their shared-memory limits are made ready there)
and captures one step of it over the carry and the caller's static page
tables.  A macro is then three parts: ``launch`` copies the inputs into
the carry and replays the graph ``n_steps`` times back to back (each
replay reads the carry the previous one wrote, and nothing is read back
in between); the caller reads the outputs back once.  Dead rows freeze
inside the graph (``decode_body``), so the reference's ``lax.cond`` skip
of a finished macro is a cost here, never a change in results.  One graph
of one step serves every macro length: no graph per power-of-2 length,
so capture time and the graph pool stay those of one step.

Every config the port serves is captured: the step body makes no host
read, routed MoE layers included (their tokens are grouped by expert on
the device, ``kernels.routed_experts``).  A capture or replay that fails
raises: nothing falls back to the eager route.  The kernels' launch
counters count Python calls, which a replay does not make: at capture
each wrapper counts its call in ``.captured``
(``kernels._build.count_launch``), and ``launch`` adds those counts x
the replays to ``.launches``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import mlstm_scan as _ms
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_attention_mla as _pam
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import routed_experts as _re
from repro_torch.kernels import slstm_scan as _ss
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig

__all__ = ["DecodeGraph"]

#: the kernel wrappers a decode step can call, whose launches a replay adds
_COUNTED = (_pa.paged_attention, _pam.paged_attention_mla,
            _re.routed_experts, _ms.mlstm_scan, _ss.slstm_scan,
            _rg.rglru_scan)


class DecodeGraph:
    """One captured decode step over static buffers (module docstring).

    params, cfg: the served model (any config the port serves); kv: the
    pools' leaves with their sinks (``SharedPagedPools.kv_with_sink``);
    tables / gid_tables: the caller's static int32 [B, n] page tables,
    which it updates in place between macros; ``max_steps``: the longest
    macro (rows of ``toks_out``); ``state_cols``: the static [B] column
    of each row's state page (configs with recurrent slots, as
    ``model.decode_step_paged``); ``cond``: the static [B, T, cond_dim]
    conditioning rows of ``.xattn`` configs, which every replay reads
    (the caller never reallocates them)."""

    def __init__(self, params, cfg: ModelConfig, kv, tables, gid_tables, *,
                 max_steps: int, page_size: int, state_cols=None, cond=None):
        dev = tables.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tables, not {dev}")
        b, n = tables.shape
        self.carry = mdl.MacroCarry.empty(b, n, max_steps, dev)
        self.carry.pos.fill_(-1)    # the warm-up writes only into the sinks
        body = functools.partial(mdl.decode_body, params, cfg, kv, tables,
                                 gid_tables, self.carry, page_size=page_size,
                                 state_cols=state_cols, cond=cond)
        # warm up on a side stream, as torch.cuda.graphs asks, then capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [k.captured for k in _COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()
        #: each counted kernel's launches in one replayed step
        self.per_step = [k.captured - c for k, c in zip(_COUNTED, before)]

    def launch(self, tokens, cur_pos, seeds, iters, emitted, max_new,
               eos_ids, temps, *, n_steps: int):
        """One macro of ``n_steps`` steps, inputs as
        ``model.decode_macro_step``'s (device tensors): copy them into
        the carry, then replay the step ``n_steps`` times.  Reads nothing
        back; returns (toks_out [n_steps, B], state) as
        ``decode_macro_step`` does, views of the carry that the next
        macro overwrites (``steps`` = ``n_steps``: every replay runs the
        model)."""
        if not 0 < n_steps <= self.carry.toks_out.shape[0]:
            raise ValueError(f"n_steps {n_steps} outside [1, "
                             f"{self.carry.toks_out.shape[0]}]")
        self.carry.load(tokens, cur_pos, seeds, iters, emitted, max_new,
                        eos_ids, temps)
        for _ in range(n_steps):
            self.graph.replay()
        for kernel, n in zip(_COUNTED, self.per_step):
            kernel.launches += n * n_steps
        return (self.carry.toks_out[:n_steps],
                mdl.macro_state(self.carry, n_steps))
