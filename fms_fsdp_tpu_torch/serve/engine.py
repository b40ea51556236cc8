"""The serving engine: params -> continuous-batching decode loop.

Counterpart of ``fms_fsdp_tpu/serve/engine.py`` for the unified role:

- params from the caller, or from a training checkpoint
  (``from_checkpoint``: a params pickle, a ``step_N_ckp`` dir or a
  ``checkpoints/`` root), cast to the compute dtype and moved to the
  device ONCE, at build;
- a :class:`~fms_fsdp_tpu_torch.serve.kv_cache.PagedKVCache` pool whose
  page size resolves statically (``tune/lookup.py``);
- the :class:`~fms_fsdp_tpu_torch.serve.scheduler.ContinuousBatchingScheduler`
  deciding admission / expiry / eviction each iteration;
- one ragged decode step over the ``max_batch`` slots per iteration,
  which runs the CUDA paged-decode kernel on the card; prefills run
  interleaved (at most ``max_prefill_per_step`` per iteration);
- with ``speculator_path`` (a ``save_speculator`` file), a Llama engine
  drafts ``spec_draft_tokens`` tokens a slot with the speculator, verifies
  them in one paged forward over n+1 positions and commits the accepted
  prefix token by token, so greedy output equals plain greedy decode.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request it raises. Greedy decode (the
default) needs no randomness; sampling draws from the engine's own
``torch.Generator``, seeded from ``seed``.

Chunked prefill, disaggregation roles and serving layouts are refused
at build, each naming its ROADMAP.md item.
"""

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fms_fsdp_tpu_torch.models.generation import sample_token
from fms_fsdp_tpu_torch.obs.registry import MetricRegistry
from fms_fsdp_tpu_torch.serve.families import FAMILY_CODES, resolve_adapter
from fms_fsdp_tpu_torch.serve.scheduler import (
    REJECT_DEADLINE_UNMEETABLE,
    REJECT_OVERLOADED,
    REJECT_TOO_LARGE,
    ContinuousBatchingScheduler,
    Request,
    RequestRejected,
)
from fms_fsdp_tpu_torch.utils.device import resolve_device
from fms_fsdp_tpu_torch.utils.tree import tree_map

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}

_EXTENSIONS = "ROADMAP.md A.10 (serving extensions)"


@dataclass(frozen=True)
class ServeConfig:
    """Engine knobs, named as in the JAX ``ServeConfig``. The three whose
    paths are not ported yet are refused by :class:`ServingEngine` at
    build unless left at their defaults."""

    max_batch: int = 8  # decode slots
    max_seq_len: int = 2048  # per-sequence cache capacity
    num_pages: int = 0  # pool size; 0 = max_batch*max_seq_len + reserved
    page_size: int = 0  # 0 = static default (tune/lookup.py)
    kv_quant: str = "none"  # "none" | "int8" | "fp8" page storage
    attn_impl: str = "auto"  # "reference" | "kernel" | "auto"
    compute_dtype: str = "bfloat16"
    # prompt lengths round up to a multiple of this before prefill
    prefill_bucket: int = 1
    max_prefill_per_step: int = 1  # prefill-decode interleave bound
    prefill_chunk_tokens: int = 0  # not served yet (ROADMAP.md A.10)
    # queued requests beyond this are rejected typed ("overloaded");
    # 0 = unbounded
    max_queue: int = 0
    # tokens/s floor for the deadline admission estimate; 0 disables
    min_decode_tokens_per_s: float = 0.0
    eos_token: Optional[int] = None
    # sampling (greedy default — the parity mode)
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 10
    # Mixtral decode's MoE: "routed" (each chosen expert over its rows)
    # or "dense" (every expert, the parity mode)
    moe_impl: str = "routed"
    # speculative serving: a save_speculator checkpoint (models/
    # speculator.py); "" off. Greedy Llama engines only.
    speculator_path: str = ""
    # draft tokens per verify step (the checkpoint's n_predict when 0)
    spec_draft_tokens: int = 0
    serve_layout: str = ""  # not served yet (ROADMAP.md A.10)
    role: str = "unified"  # only "unified" is served (ROADMAP.md A.10)


def _check_supported(scfg: ServeConfig) -> None:
    if scfg.role != "unified":
        raise NotImplementedError(
            f"role={scfg.role!r}: disaggregated serving is not ported yet "
            f"({_EXTENSIONS}); run role='unified'"
        )
    if scfg.prefill_chunk_tokens:
        raise NotImplementedError(
            f"prefill_chunk_tokens={scfg.prefill_chunk_tokens}: chunked "
            f"prefill is not ported yet ({_EXTENSIONS}); leave it 0"
        )
    if scfg.serve_layout:
        raise NotImplementedError(
            f"serve_layout={scfg.serve_layout!r}: sharded replicas are not "
            f"ported yet ({_EXTENSIONS}); run single-card"
        )


def _to_device(params, device, dtype):
    """Nested params -> ``device`` and ``dtype``: one cast per leaf, none
    at all where a leaf already matches."""
    return tree_map(lambda w: w.to(device=device, dtype=dtype), params)


class ServingEngine:
    def __init__(
        self,
        params,
        model_cfg,
        serve_cfg: Optional[ServeConfig] = None,
        registry: Optional[MetricRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
        seed: int = 0,
        device=None,
    ):
        scfg = serve_cfg or ServeConfig()
        _check_supported(scfg)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.serve_cfg = scfg
        self.registry = registry or MetricRegistry()
        self.clock = clock
        self.compute_dtype = _DTYPES[scfg.compute_dtype]
        # the one cast of the weights to the compute dtype
        self.params = _to_device(params, self.device, self.compute_dtype)

        self.adapter = resolve_adapter(
            self.params, model_cfg, scfg, self.compute_dtype, self.device
        )
        self.family = self.adapter.family
        self.cache = self.adapter.cache
        self.page_size = self.adapter.page_size
        self.max_pages = self.adapter.max_pages
        self.attn_impl = self.adapter.attn_impl
        self.block_kv = self.adapter.block_kv

        self.scheduler = ContinuousBatchingScheduler(
            scfg.max_batch,
            max_prefill_per_step=scfg.max_prefill_per_step,
            clock=clock,
        )
        self._slots: List[Optional[Request]] = [None] * scfg.max_batch
        self._admit_order: List[Request] = []
        self._tokens = np.zeros((scfg.max_batch,), np.int32)
        self._lens = np.zeros((scfg.max_batch,), np.int32)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._decode_tokens = 0
        self._decode_wall = 0.0
        self._spec_draft_total = 0  # draft tokens offered to verify
        self._spec_accept_total = 0  # draft tokens accepted
        self._finished_buf: List[Request] = []
        self.last_logits = None  # (B, V) of the last decode step
        self.decode_steps = 0  # ragged decode steps run

    # -- construction ------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls, path: str, model_cfg, serve_cfg: Optional[ServeConfig] = None,
        **kw,
    ) -> "ServingEngine":
        """Restore params from a training checkpoint and build the engine
        around them: a params pickle (numpy leaves, as
        ``bridge.params_to_numpy`` and the JAX package write them), a
        ``step_N_ckp`` dir, or a ``checkpoints/`` root, whose newest
        committed step dir is read (torn and loader-only dirs skipped).
        Only the params are read (``utils/checkpointing.py::
        load_params_only``)."""
        from fms_fsdp_tpu_torch.utils.checkpointing import load_params_only

        return cls(load_params_only(path), model_cfg, serve_cfg, **kw)

    # -- request side ------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Queue one request. ``deadline_s`` is relative to now; a
        request still queued past it is expired unserved.

        Raises :class:`RequestRejected` (a ValueError subclass) with a
        machine-readable ``reason`` — ``too_large`` / ``overloaded`` /
        ``deadline_unmeetable`` — and bumps the per-reason
        ``serve.requests_rejected.<reason>`` counter."""
        deadline = None if deadline_s is None else self.clock() + deadline_s
        # a verify step writes up to spec_draft_tokens positions past the
        # committed length before the accept rule rolls back: those
        # positions must exist, so the budget tightens by draft - 1
        slack = max(0, self.adapter.spec_draft_tokens - 1)
        if len(prompt) + max_new_tokens + slack > self.serve_cfg.max_seq_len:
            extra = f" + {slack} draft headroom" if slack else ""
            self._reject(
                REJECT_TOO_LARGE,
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}){extra} exceeds max_seq_len "
                f"({self.serve_cfg.max_seq_len})",
            )
        err = self.adapter.admission_error(len(prompt), max_new_tokens)
        if err is not None:
            self._reject(REJECT_TOO_LARGE, err)
        if (
            self.serve_cfg.max_queue
            and self.scheduler.queue_depth() >= self.serve_cfg.max_queue
        ):
            self._reject(
                REJECT_OVERLOADED,
                f"queue holds {self.scheduler.queue_depth()} requests "
                f"(max_queue={self.serve_cfg.max_queue}): shedding at "
                f"admission — back off and retry",
            )
        rate = self.serve_cfg.min_decode_tokens_per_s
        if deadline_s is not None and rate > 0:
            floor_s = max_new_tokens / rate
            if deadline_s < floor_s:
                self._reject(
                    REJECT_DEADLINE_UNMEETABLE,
                    f"deadline {deadline_s:.3f}s < {floor_s:.3f}s floor "
                    f"({max_new_tokens} tokens at the configured "
                    f"min_decode_tokens_per_s={rate:g}) — unmeetable "
                    f"even by an idle engine",
                )
        req = self.scheduler.submit(
            Request(list(prompt), max_new_tokens, deadline)
        )
        self.registry.counter("serve.requests_submitted").add()
        return req

    def _reject(self, reason: str, msg: str):
        self.registry.counter(f"serve.requests_rejected.{reason}").add()
        raise RequestRejected(reason, msg)

    # -- prefill -----------------------------------------------------------

    def _prefill_request(self, req: Request, slot: int) -> None:
        prompt = req.resume_prompt()
        row = self.adapter.prefill(req.rid, slot, prompt)
        tok = int(
            sample_token(
                row[None],
                self.generator,
                self.serve_cfg.temperature,
                self.serve_cfg.top_k,
                self.serve_cfg.do_sample,
            )[0]
        )
        now = self.clock()
        if req.first_token_time is None:
            req.first_token_time = now
            self.registry.hist("serve.ttft_s").record(now - req.submit_time)
        p = len(prompt)
        req.generated.append(tok)
        self.registry.counter("serve.prefill_tokens").add(p)
        self._slots[slot] = req
        self._admit_order.append(req)
        self._tokens[slot] = tok
        self._lens[slot] = p
        self._finish_if_done(req, slot, now=now)

    # -- lifecycle helpers -------------------------------------------------

    def _finish_if_done(self, req: Request, slot: int, now=None) -> bool:
        done = len(req.generated) >= req.max_new_tokens or (
            self.serve_cfg.eos_token is not None
            and req.generated
            and req.generated[-1] == self.serve_cfg.eos_token
        )
        if not done:
            return False
        self.scheduler.mark_finished(req, now=now)
        self._release_slot(req, slot)
        self._finished_buf.append(req)
        self.registry.counter("serve.requests_completed").add()
        self.registry.hist("serve.request_latency_s").record(req.latency)
        return True

    def _release_slot(self, req: Request, slot: int) -> None:
        self.adapter.release(req.rid, slot)
        self._slots[slot] = None
        if req in self._admit_order:
            self._admit_order.remove(req)
        self._tokens[slot] = 0
        self._lens[slot] = 0

    def _evict(self, victim: Request) -> None:
        slot = self._slots.index(victim)
        self._release_slot(victim, slot)
        self.scheduler.mark_evicted(victim)
        self.registry.counter("serve.requests_evicted").add()

    # -- the engine iteration ----------------------------------------------

    def step(self) -> List[Request]:
        """One continuous-batching iteration: expire, admit (+prefill),
        one ragged decode step, harvest finishes. Returns the requests
        that finished during this iteration."""
        now = self.clock()
        for _ in self.scheduler.expire_queued(now):
            self.registry.counter("serve.requests_expired").add()
        running = [r for r in self._slots if r is not None]
        for r in self.scheduler.expire_inflight(running, now):
            self._release_slot(r, self._slots.index(r))
            self.registry.counter("serve.requests_expired_inflight").add()

        def can_fit(req: Request) -> bool:
            return self.adapter.can_admit(req.rid, len(req.resume_prompt()))

        # admit ONE at a time, prefilling (and so allocating) before the
        # next can_fit check: a batched admit would check every candidate
        # against the pre-prefill pool and over-admit
        for _ in range(self.serve_cfg.max_prefill_per_step):
            if self._slots.count(None) <= 0:
                break
            got = self.scheduler.admit(1, can_fit)
            if not got:
                break
            self._prefill_request(got[0], self._slots.index(None))

        # token-granular growth; evict (LIFO) when the pool is dry. A
        # speculative stream reserves the positions its drafts are written
        # at before the accept rule rolls back.
        draft = self.adapter.spec_draft_tokens
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            while not self.adapter.grow(req.rid, int(self._lens[slot]) + 1 + draft):
                victim = self.scheduler.evict_victim(self._admit_order)
                if victim is None:
                    raise RuntimeError("no victim but pool exhausted")
                self._evict(victim)
                if victim is req:
                    break

        active = [(slot, r) for slot, r in enumerate(self._slots) if r is not None]
        if active and self.adapter.speculative:
            t0 = self.clock()
            emit, counts, logits = self.adapter.decode_spec(
                [r.rid if r is not None else None for r in self._slots],
                self._lens,
                self._tokens,
            )
            self.last_logits = logits
            self.decode_steps += 1
            self._decode_wall += self.clock() - t0
            for slot, req in active:
                self._spec_draft_total += draft
                self._spec_accept_total += int(counts[slot]) - 1
                # commit the accepted prefix token by token: eos and
                # max_new_tokens cut exactly where plain decode stops
                for j in range(int(counts[slot])):
                    self._lens[slot] += 1
                    tok = int(emit[slot, j])
                    req.generated.append(tok)
                    self._tokens[slot] = tok
                    self._decode_tokens += 1
                    self.registry.counter("serve.decode_tokens").add()
                    if self._finish_if_done(req, slot):
                        break
        elif active:
            t0 = self.clock()
            toks, logits = self.adapter.decode(
                [r.rid if r is not None else None for r in self._slots],
                self._lens,
                self._tokens,
                self.generator,
            )
            self.last_logits = logits
            self.decode_steps += 1
            self._decode_wall += self.clock() - t0
            self._decode_tokens += len(active)
            self.registry.counter("serve.decode_tokens").add(len(active))
            for slot, req in active:
                self._lens[slot] += 1
                tok = int(toks[slot])
                req.generated.append(tok)
                self._tokens[slot] = tok
                self._finish_if_done(req, slot)

        self.registry.gauge("serve.queue_depth").set(
            self.scheduler.queue_depth()
        )
        self.registry.gauge("serve.kv_pages_in_use").set(
            self.adapter.pages_in_use
        )
        if self._decode_wall > 0:
            self.registry.gauge("serve.tokens_per_s").set(
                self._decode_tokens / self._decode_wall
            )
        out, self._finished_buf = self._finished_buf, []
        return out

    def run(self, max_steps: int = 100000) -> None:
        """Drive step() until queue and slots drain (or max_steps)."""
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()

    def has_work(self) -> bool:
        return bool(self.scheduler.queue) or any(
            r is not None for r in self._slots
        )

    # -- obs ---------------------------------------------------------------

    def serving_stats(self) -> Dict[str, float]:
        """The flat str->number ``serving`` map of the JAX engine, with
        the fields of paths this port does not serve yet at their idle
        values (role unified = 0, single-card layout = 0, no handoff, no
        chunks, never drained)."""
        ttft = self.registry.hist("serve.ttft_s").reduce(clear=False)
        lat = sorted(self.registry.hist("serve.request_latency_s").samples)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else 0.0
        return {
            "tokens_per_s": (
                self._decode_tokens / self._decode_wall
                if self._decode_wall > 0
                else 0.0
            ),
            "ttft_s": ttft.get("mean", 0.0),
            "queue_depth": float(self.scheduler.queue_depth()),
            "kv_pages_in_use": float(self.adapter.pages_in_use),
            "requests_completed": float(self.scheduler.completed),
            "requests_evicted": float(self.scheduler.evicted),
            "requests_expired": float(self.scheduler.expired),
            "requests_expired_inflight": float(
                self.scheduler.expired_inflight
            ),
            "p99_latency_s": p99,
            "family": float(FAMILY_CODES[self.family]),
            "state_bytes_per_stream": float(
                self.adapter.state_bytes_per_stream
            ),
            "role": 0.0,
            "serve_layout": 0.0,
            "handoff_bytes": 0.0,
            "handoff_s": 0.0,
            "spec_accept_rate": (
                self._spec_accept_total / self._spec_draft_total
                if self._spec_draft_total
                else 0.0
            ),
            "spec_draft_tokens": float(self.adapter.spec_draft_tokens),
            "prefill_chunks": 0.0,
            "paged_kernel_impl": float(self._paged_kernel_impl()),
            "drained": 0.0,
        }

    def _paged_kernel_impl(self) -> int:
        """0 = reference gather, 1 = kernel on the v1 contract, 2 = kernel
        on the v2 contract (quantized pools or a wider block_kv)."""
        if self.attn_impl != "kernel":
            return 0
        if self.serve_cfg.kv_quant != "none" or (
            self.block_kv and self.page_size
            and self.block_kv != self.page_size
        ):
            return 2
        return 1
