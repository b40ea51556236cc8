"""The serving engine: params -> continuous-batching decode loop.

Counterpart of ``fms_fsdp_tpu/serve/engine.py``:

- params from the caller, or from a training checkpoint
  (``from_checkpoint``: a params pickle, a ``step_N_ckp`` dir or a
  ``checkpoints/`` root), cast to the compute dtype and moved to the
  device ONCE, at build;
- a :class:`~fms_fsdp_tpu_torch.serve.kv_cache.PagedKVCache` pool whose
  page size and decode split resolve once, at build, through the tuning
  table (``tune/lookup.py::resolve_paged_decode``: table or static
  defaults, ``tune_how`` says which);
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

Disaggregation (``role``): a ``prefill`` engine packs each stream's
pages and sampling state into handoff wire bytes after its first token
(``serve/disagg/handoff.py``) and retires it; a ``decode`` engine also
admits those bytes (``submit_handoff``) and continues the stream with no
prefill. ``pack_stream`` packs a live stream without retiring it (the
drain-and-migrate read of ``serve/replica.py``). Chunked prefill
(``prefill_chunk_tokens``) advances long prompts one chunk per step,
interleaved with decode. Serving layouts (``serve_layout``) are refused
at build, naming ROADMAP.md A.6b.
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

@dataclass(frozen=True)
class ServeConfig:
    """Engine knobs, named as in the JAX ``ServeConfig``. ``serve_layout``
    is refused by :class:`ServingEngine` at build unless left empty."""

    max_batch: int = 8  # decode slots
    max_seq_len: int = 2048  # per-sequence cache capacity
    num_pages: int = 0  # pool size; 0 = max_batch*max_seq_len + reserved
    page_size: int = 0  # 0 = the tuning table's, else the static default (tune/lookup.py)
    kv_quant: str = "none"  # "none" | "int8" | "fp8" page storage
    attn_impl: str = "auto"  # "reference" | "kernel" | "auto"
    compute_dtype: str = "bfloat16"
    # prompt lengths round up to a multiple of this before prefill
    prefill_bucket: int = 1
    max_prefill_per_step: int = 1  # prefill-decode interleave bound
    # chunked prefill: prompts longer than this advance one chunk-sized
    # slice per engine step, interleaved with decode; 0 = whole prompt
    prefill_chunk_tokens: int = 0
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
    serve_layout: str = ""  # not served yet (ROADMAP.md A.6b)
    # disaggregation role: "unified" serves end to end; "prefill" packs a
    # handoff after the first token instead of decoding; "decode" also
    # admits submit_handoff() resumes (and can still prefill: eviction
    # recompute needs that)
    role: str = "unified"
    # a prefill engine rejects (too_large) any request whose packed
    # handoff could exceed this many bytes; 0 = unbounded
    handoff_max_bytes: int = 0


def _check_supported(scfg: ServeConfig) -> None:
    from fms_fsdp_tpu_torch.serve.disagg import ROLES

    if scfg.role not in ROLES:
        raise ValueError(
            f"unknown serving role {scfg.role!r}: expected one of {ROLES}"
        )
    if scfg.serve_layout:
        raise NotImplementedError(
            f"serve_layout={scfg.serve_layout!r}: a serving replica over a "
            f"tensor-parallel mesh is not ported yet (ROADMAP.md A.6b, the "
            f"serving layout; tensor parallelism runs in training); run "
            f"single-card"
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
        if scfg.role != "unified" and not self.adapter.supports_handoff:
            raise ValueError(
                f"role={scfg.role!r} needs handoff, which the {self.family} "
                f"family does not support — run {self.family} replicas unified"
            )
        if scfg.prefill_chunk_tokens and not self.adapter.supports_chunked_prefill:
            raise ValueError(
                f"prefill_chunk_tokens={scfg.prefill_chunk_tokens} is not "
                f"supported for the {self.family} family yet — unset it "
                f"(whole-prompt prefill)"
            )
        self.cache = self.adapter.cache
        self.page_size = self.adapter.page_size
        self.max_pages = self.adapter.max_pages
        self.attn_impl = self.adapter.attn_impl
        self.block_kv = self.adapter.block_kv
        self.tune_how = self.adapter.tune_how

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
        # handoff imports that failed typed AFTER admission (the adapter
        # freed its allocations): the replica loop drains these through
        # take_failed() and rejects them back to the router
        self._failed_buf: List[Request] = []
        self.last_logits = None  # (B, V) of the last decode step
        self.decode_steps = 0  # ragged decode steps run
        self.iterations = 0  # step() count (health and fault context)
        self._draining = False
        self._handoff_bytes = 0  # wire bytes packed out + imported in
        self._handoff_wall = 0.0  # seconds spent packing / scattering
        self._chunking: Dict[int, tuple] = {}  # rid -> (req, slot)
        self._prefill_chunks = 0

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
        # ckpt before utils.checkpointing: the other order is a circular import
        from fms_fsdp_tpu_torch import ckpt  # noqa: F401
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
            self.serve_cfg.role == "prefill"
            and self.serve_cfg.handoff_max_bytes
            and self.adapter.cache is not None
        ):
            # a prefill engine's output is the packed page set: bound it
            # at the door (pure page bytes; the header adds O(prompt))
            cache = self.adapter.cache
            need = cache.pages_needed(
                self.adapter._padded_len(len(prompt), self.serve_cfg.prefill_bucket)
            )
            est = need * cache.page_bytes()
            if est > self.serve_cfg.handoff_max_bytes:
                self._reject(
                    REJECT_TOO_LARGE,
                    f"packed handoff would carry ~{est} bytes of KV "
                    f"pages ({need} pages), over handoff_max_bytes="
                    f"{self.serve_cfg.handoff_max_bytes} — shrink the "
                    f"prompt or raise the cap",
                )
        self._check_queue()
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
        self._check_draining()
        req = self.scheduler.submit(
            Request(list(prompt), max_new_tokens, deadline)
        )
        self.registry.counter("serve.requests_submitted").add()
        return req

    def _reject(self, reason: str, msg: str):
        self.registry.counter(f"serve.requests_rejected.{reason}").add()
        raise RequestRejected(reason, msg)

    def _check_queue(self) -> None:
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

    def _check_draining(self) -> None:
        if self._draining:
            self._reject(
                REJECT_OVERLOADED,
                "engine is draining: not admitting new requests",
            )

    def submit_handoff(
        self,
        data: bytes,
        max_new_tokens: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Admit a request by resuming packed handoff bytes (what a
        prefill-role engine or ``pack_stream`` produced) instead of
        prefilling: the header restores the stream's position (prompt,
        generated, seq_len) and its pages (or slab) are written into this
        engine at admission. ``max_new_tokens``/``deadline_s`` default to
        the header's values.

        Raises :class:`~fms_fsdp_tpu_torch.serve.disagg.HandoffError` (a
        ValueError) on malformed or geometry-mismatched bytes and
        :class:`RequestRejected` on admission failure."""
        from fms_fsdp_tpu_torch.serve.disagg import unpack_handoff

        if not self.adapter.supports_handoff:
            raise ValueError(
                f"the {self.family} family does not support handoff — "
                f"route its requests to unified replicas"
            )
        if self.adapter.speculative:
            raise ValueError(
                "a speculative engine cannot resume handoffs: the draft "
                "state (the last base hidden state) is not part of the "
                "handoff — route resumes to non-speculative replicas"
            )
        header, arrays = unpack_handoff(data)
        self.adapter.check_handoff_header(header)
        prompt = [int(t) for t in header["prompt"]]
        generated = [int(t) for t in header["generated"]]
        mnt = int(header["max_new_tokens"] if max_new_tokens is None else max_new_tokens)
        deadline = None if deadline_s is None else self.clock() + deadline_s
        if len(prompt) + mnt > self.serve_cfg.max_seq_len:
            self._reject(
                REJECT_TOO_LARGE,
                f"handoff prompt ({len(prompt)}) + max_new_tokens "
                f"({mnt}) exceeds max_seq_len "
                f"({self.serve_cfg.max_seq_len})",
            )
        err = self.adapter.admission_error(len(prompt), mnt)
        if err is not None:
            self._reject(REJECT_TOO_LARGE, err)
        self._check_queue()
        self._check_draining()
        req = Request(prompt, mnt, deadline)
        req.generated = generated
        req.handoff_in = (header, arrays, len(data))
        self.scheduler.submit(req)
        # the first token was served where the prefill ran: this stream
        # never expires as unserved queued work, and its TTFT was
        # recorded there
        req.first_token_time = req.submit_time
        self.registry.counter("serve.requests_submitted").add()
        self.registry.counter("serve.handoffs_accepted").add()
        return req

    # -- prefill -----------------------------------------------------------

    def _prefill_request(self, req: Request, slot: int) -> None:
        if req.handoff_in is not None:
            self._import_handoff(req, slot)
            return
        prompt = req.resume_prompt()
        chunk = self.serve_cfg.prefill_chunk_tokens
        if chunk and len(prompt) > chunk:
            # chunked prefill: allocate and stage now, advance one chunk
            # per step() interleaved with decode; the slot joins the
            # decode batch once the whole prompt is in
            self.adapter.prefill_start(req.rid, slot, prompt)
            self._slots[slot] = req
            self._chunking[req.rid] = (req, slot)
            return
        row = self.adapter.prefill(req.rid, slot, prompt)
        self._complete_prefill(req, slot, row, len(prompt))

    def _complete_prefill(self, req: Request, slot: int, row, p: int) -> None:
        """Shared tail of whole-prompt and chunked prefill: sample the
        first token from the last real prompt position's logits row,
        record TTFT, promote the stream into the decode batch."""
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
        req.generated.append(tok)
        self.registry.counter("serve.prefill_tokens").add(p)
        self._slots[slot] = req
        self._admit_order.append(req)
        self._tokens[slot] = tok
        self._lens[slot] = p
        if self._finish_if_done(req, slot, now=now):
            return
        if self.serve_cfg.role == "prefill":
            # a prefill engine's job ends at the first token: pack the
            # stream and retire it; the replica loop ships the bytes
            self._export_handoff(req, slot)

    def _import_handoff(self, req: Request, slot: int) -> None:
        """The decode half of a handoff admission: write the shipped
        state into this engine and restore the stream's position — no
        prefill compute at all."""
        from fms_fsdp_tpu_torch.serve.disagg import HandoffError

        header, arrays, nbytes = req.handoff_in
        t0 = self.clock()
        try:
            ok = self.adapter.import_handoff(req.rid, slot, header, arrays)
        except HandoffError as e:
            # the frame passed the submit-time header check but failed
            # mid-import; the adapter freed what it allocated, so the
            # request fails typed and the router requeues it
            req.handoff_in = None
            req.state = "failed"
            req.fail_reason = f"handoff_error: {e}"
            self._failed_buf.append(req)
            self.registry.counter("serve.handoffs_failed").add()
            return
        if not ok:
            raise RuntimeError("admission checked capacity; the import cannot fail here")
        self._handoff_wall += self.clock() - t0
        self._handoff_bytes += nbytes
        self.registry.counter("serve.handoffs_imported").add()
        self.registry.counter("serve.handoff_bytes").add(nbytes)
        req.handoff_in = None  # eviction after this point recomputes
        self._slots[slot] = req
        self._admit_order.append(req)
        self._tokens[slot] = req.generated[-1]
        self._lens[slot] = int(header["seq_len"])
        self._finish_if_done(req, slot)

    def _pack(self, req: Request, slot: int) -> bytes:
        """The stream's decode state plus its sampling state, packed."""
        from fms_fsdp_tpu_torch.serve.disagg import pack_handoff

        header, arrays = self.adapter.export_handoff(req.rid, slot)
        header.update(
            prompt=[int(t) for t in req.prompt],
            generated=[int(t) for t in req.generated],
            seq_len=int(self._lens[slot]),
            max_new_tokens=int(req.max_new_tokens),
        )
        data = pack_handoff(header, arrays)
        self._handoff_bytes += len(data)
        self.registry.counter("serve.handoffs_exported").add()
        self.registry.counter("serve.handoff_bytes").add(len(data))
        return data

    def _export_handoff(self, req: Request, slot: int) -> None:
        """The prefill half: pack the stream, then retire it — its pages
        free only AFTER the gather read them."""
        t0 = self.clock()
        req.handoff_out = self._pack(req, slot)
        self._handoff_wall += self.clock() - t0
        self.scheduler.mark_finished(req)
        self._release_slot(req, slot)
        self._finished_buf.append(req)

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
        self._chunking.pop(req.rid, None)
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
        self.iterations += 1
        for _ in self.scheduler.expire_queued(now):
            self.registry.counter("serve.requests_expired").add()
        running = [r for r in self._slots if r is not None]
        for r in self.scheduler.expire_inflight(running, now):
            self._release_slot(r, self._slots.index(r))
            self.registry.counter("serve.requests_expired_inflight").add()

        def can_fit(req: Request) -> bool:
            if req.handoff_in is not None:
                # a handoff allocates the shipped page set; seq_len is the
                # position its pages cover
                return self.adapter.can_admit(req.rid, int(req.handoff_in[0]["seq_len"]))
            return self.adapter.can_admit(req.rid, len(req.resume_prompt()))

        # admit ONE at a time, prefilling (and so allocating) before the
        # next can_fit check: a batched admit would check every candidate
        # against the pre-prefill pool and over-admit
        for _ in range(0 if self._draining else self.serve_cfg.max_prefill_per_step):
            if self._slots.count(None) <= 0:
                break
            got = self.scheduler.admit(1, can_fit)
            if not got:
                break
            self._prefill_request(got[0], self._slots.index(None))

        # advance each staged chunked prefill by ONE chunk, interleaved
        # with the decode below
        for rid in list(self._chunking):
            req, slot = self._chunking[rid]
            row = self.adapter.prefill_chunk(rid)
            self._prefill_chunks += 1
            self.registry.counter("serve.prefill_chunks").add()
            if row is not None:
                del self._chunking[rid]
                self._complete_prefill(req, slot, row, len(req.resume_prompt()))

        # token-granular growth; evict (LIFO) when the pool is dry. A
        # speculative stream reserves the positions its drafts are written
        # at before the accept rule rolls back.
        draft = self.adapter.spec_draft_tokens
        for slot, req in enumerate(self._slots):
            if req is None or req.rid in self._chunking:
                continue
            while not self.adapter.grow(req.rid, int(self._lens[slot]) + 1 + draft):
                victim = self.scheduler.evict_victim(self._admit_order)
                if victim is None:
                    raise RuntimeError("no victim but pool exhausted")
                self._evict(victim)
                if victim is req:
                    break

        slot_rids = [
            r.rid if r is not None and r.rid not in self._chunking else None
            for r in self._slots
        ]
        active = [(slot, r) for slot, r in enumerate(self._slots)
                  if r is not None and r.rid not in self._chunking]
        if active and self.adapter.speculative:
            t0 = self.clock()
            emit, counts, logits = self.adapter.decode_spec(
                slot_rids,
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
                slot_rids,
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

    # -- fleet hooks -------------------------------------------------------

    def drain(self) -> None:
        """Stop admitting: queued and new requests are refused, running
        streams finish; ``drained`` flips once the slots empty."""
        self._draining = True

    def take_failed(self) -> List[Request]:
        """Requests that failed typed after admission (a handoff import
        rejected mid-apply): the replica loop rejects them back to the
        router, which requeues them for re-prefill."""
        out, self._failed_buf = self._failed_buf, []
        return out

    def live_requests(self) -> List[Request]:
        """The running (slot-holding) streams, in admission order: what
        drain-and-migrate packs before the process exits."""
        return [r for r in self._admit_order if r in self._slots]

    def pack_stream(self, req: Request) -> Optional[bytes]:
        """Pack a LIVE decode stream into handoff wire bytes WITHOUT
        retiring it (the drain-and-migrate read): the stream resumes
        mid-decode elsewhere through ``submit_handoff``. None for streams
        that cannot travel: mid-chunked-prefill, or a speculative engine's
        (its draft state is not in the frame)."""
        if not self.adapter.supports_handoff or self.adapter.speculative:
            return None
        if req.rid in self._chunking or req not in self._slots:
            return None
        return self._pack(req, self._slots.index(req))

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        return self._draining and all(r is None for r in self._slots)

    def health(self) -> Dict[str, float]:
        """One flat liveness snapshot (the replica's heartbeat payload)."""
        return {
            "iterations": float(self.iterations),
            "slots_busy": float(sum(r is not None for r in self._slots)),
            "queue_depth": float(self.scheduler.queue_depth()),
            "kv_pages_in_use": float(self.adapter.pages_in_use),
            "draining": float(self._draining),
        }

    # -- obs ---------------------------------------------------------------

    def serving_stats(self) -> Dict[str, float]:
        """The flat str->number ``serving`` map of the JAX engine (obs
        schema v15); ``serve_layout`` is 0, the single-card layout."""
        from fms_fsdp_tpu_torch.serve.disagg import ROLE_CODES

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
            "role": float(ROLE_CODES[self.serve_cfg.role]),
            "serve_layout": 0.0,
            "handoff_bytes": float(self._handoff_bytes),
            "handoff_s": float(self._handoff_wall),
            "spec_accept_rate": (
                self._spec_accept_total / self._spec_draft_total
                if self._spec_draft_total
                else 0.0
            ),
            "spec_draft_tokens": float(self.adapter.spec_draft_tokens),
            "prefill_chunks": float(self._prefill_chunks),
            "paged_kernel_impl": float(self._paged_kernel_impl()),
            "drained": float(self.drained),
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
