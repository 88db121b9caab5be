"""Batched serving engine: request queue -> slot-based continuous batching.

A fixed decode batch of ``slots``; finished or empty slots are refilled
from the queue by running a prefill for the incoming prompt and splicing
its cache into the slot.  Prefill and decode are eager calls of the model
API (the reference compiles each with ``jax.jit``); on the GPU a dense or
MoE model's reach the hand-written flash-attention kernel once a layer per
prefill and the decode-attention kernel once a layer per decode step, an
RWKV-6 model's the WKV6 kernel once a layer in both, the hybrid's the
RG-LRU kernel once a recurrent block in both and the flash-attention kernel
once an attention block per prefill, and the encoder-decoder's the
flash-attention kernel once an encoder layer and twice a decoder layer per
prefill (whose frames are zeros, as the reference's engine makes them)
and the decode-attention kernel twice a decoder layer per decode step.

Sampling: greedy or temperature, on the host from float32 logits, with
``np.random.default_rng(seed)``: deterministic per (seed, request order).

Robustness: each request carries a ``deadline_steps`` budget; one that
decodes past it is evicted with status ``timed_out``.  A
:class:`~repro_torch.core.faults.FaultInjector` can fail prefills and
decodes deterministically; injected failures
(:class:`~repro_torch.core.faults.InjectedError`) retry under the
:class:`~repro_torch.core.faults.RecoveryPolicy`, and a request whose
retries run out completes with status ``error``: the batch loop never
stalls on one bad request.  Any other exception, such as a kernel's CUDA
error, is not retried and propagates to the caller (the reference retries
and absorbs every exception).

Over ranks: given ``rules`` on a mesh of ranks, every rank runs the same
engine and keeps the same host book (the queue, ``slot_req``, the slots'
tokens, the generator).  Over a ``"model"`` axis of more than one rank
(every family) each rank holds its slice of the parameters
(``models.api.init_params(..., rules)``) and of the decode state
(``models.api.state_specs``: its KV heads, its run of the cache's sequence
where the rules split it (``shard_seq``), its recurrent channels, its WKV
heads), which the splice copies leaf by leaf as it lies; the logits come
gathered over those ranks.  Over the data axes (``batch_ranks`` of the
rules; the slot count must split evenly) data rank d holds slots
``[d S / D, (d + 1) S / D)``: each decode step runs its rows, and the
logits are gathered over the data axes; a prefill runs only on the owning
data rank's model group, and its last logits row reaches the others by
one all-gather in which they give zeros; only the owner splices.  Every
rank then samples every slot in slot order with the same generator, so
the tokens are the one-rank engine's, temperature included, and every rank
probes the fault injector for every prefill and decode attempt in the same
order, owner or not, so that retries and ``error`` statuses agree.  The
ranks compare their tokens after every prefill and decode step (an
all-gather over the whole mesh): a rank that took another token would
leave the others waiting in a collective, so the engine raises on every
rank instead.

Timing: a decode step's latency (``serve.decode_step_s``) and a request's
time to first token (``serve.ttft_s``) end when the logits have reached
the host, so they include the device's work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.faults import (FaultInjector, InjectedError,
                                     RecoveryPolicy)
from repro_torch.device import resolve_device
from repro_torch.dist import ranks
from repro_torch.dist.sharding import batch_axes, batch_ranks
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    deadline_steps: int | None = None  # decode-step budget (None = engine's)
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "pending"  # -> "ok" | "timed_out" | "error"


class ServeEngine:
    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        *,
        slots: int = 4,
        max_len: int = 512,
        rules=None,
        seed: int = 0,
        deadline_steps: int | None = None,
        fault_injector: FaultInjector | None = None,
        recovery: RecoveryPolicy | None = None,
        registry: MetricsRegistry | None = None,
        tracer=None,
        clock: Callable[[], float] | None = None,
        device: torch.device | str | None = None,
    ):
        """``device=None`` means the GPU; the parameters must be there.
        With ``rules`` on a mesh of ranks, every rank of the mesh makes
        this engine with its own part of the parameters."""
        self.device = resolve_device(device)
        self._world = 1  # ranks of the mesh
        self._data = 1  # ranks the slots split over
        self._data_index = 0
        if rules is not None and rules.mesh is not None:
            for n in ranks.mesh_sizes(rules.mesh).values():
                self._world *= n
            self._data = batch_ranks(rules)
            if slots % self._data:
                raise ValueError(f"{slots} slots do not split over "
                                 f"{self._data} data ranks")
            if self._data > 1:
                with ranks.use_mesh(rules.mesh):
                    self._data_index = ranks.axis_index(batch_axes(rules))
        self._local = slots // self._data  # slots a data rank holds
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.rules = rules
        self.rng = np.random.default_rng(seed)
        self.deadline_steps = deadline_steps
        self.fault_injector = fault_injector
        self.recovery = recovery or RecoveryPolicy()
        self.tracer = tracer or NULL_TRACER
        self._registry = registry
        if clock is not None:
            self.clock = clock
        elif self.tracer.enabled:
            self.clock = self.tracer.now
        else:
            self.clock = time.perf_counter
        self._submit_ts: dict[int, float] = {}

        self._decode = lambda p, tok, st: model_api.decode_step(
            p, tok, cfg, st, rules)
        self._prefill = lambda p, batch, st: model_api.prefill(
            p, batch, cfg, st, rules)
        self.state = model_api.init_decode_state(cfg, self._local, max_len,
                                                 self.device, rules)
        self.slot_req: list[Request | None] = [None] * slots
        self.slot_tokens = np.zeros((slots,), np.int32)
        self.slot_age = np.zeros((slots,), np.int64)  # decode steps in slot
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0, "steps": 0,
                      "timed_out": 0, "errors": 0, "retries": 0}

    # -- API --------------------------------------------------------------------

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self._submit_ts[req.rid] = self.clock()
        self.registry.gauge("serve.queue_depth").set(len(self.queue))

    def run(self, max_steps: int = 1000) -> list[Request]:
        """Drive until queue + slots drain (or step budget)."""
        for _ in range(max_steps):
            self._fill_slots()
            if all(r is None for r in self.slot_req):
                break
            self._decode_once()
        return self.completed

    # -- internals ----------------------------------------------------------------

    _TERMINAL_STATUS = {"ok": "completed", "timed_out": "timed_out",
                        "error": "error"}

    def _finish(self, slot: int, req: Request, status: str) -> None:
        req.status = status
        req.done = True
        self.completed.append(req)
        self.slot_req[slot] = None
        self._submit_ts.pop(req.rid, None)
        self.registry.counter("serve.requests").labels(
            status=self._TERMINAL_STATUS.get(status, status)).inc()

    def _owner(self, slot: int) -> int:
        """The data rank that holds ``slot``."""
        return slot // self._local

    def owns(self, slot: int) -> bool:
        """Whether this rank's data group holds ``slot`` (and so runs the
        prefills that fill it)."""
        return self._owner(slot) == self._data_index

    def _gathered(self, rows: torch.Tensor | None, n: int) -> np.ndarray:
        """The f32 logits (n x D rows, vocab) on the host, in slot order:
        ``rows`` (n, vocab) this data rank's, all-gathered over the data
        axes; None gives zeros (a rank that holds no rows of them)."""
        if rows is None:
            rows = torch.zeros((n, self.cfg.vocab), dtype=torch.float32,
                               device=self.device)
        rows = rows.float()
        if self._data > 1:
            with ranks.use_mesh(self.rules.mesh):
                rows = ranks.all_gather(rows.contiguous(),
                                        batch_axes(self.rules))
            rows = rows.reshape(-1, rows.shape[-1])
        return _host_logits(rows)

    def _fill_slots(self) -> None:
        for s in range(self.slots):
            while self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.registry.gauge("serve.queue_depth").set(len(self.queue))
                owner = self._owner(s)
                mine = self.owns(s)
                try:
                    with self.tracer.span(f"prefill:r{req.rid}",
                                          stream="serve", cat="compute",
                                          rid=req.rid, slot=s,
                                          prompt_len=len(req.prompt)):
                        out = self._prefill_with_retry(req, mine)
                        last = self._gathered(
                            out[0][:, -1] if mine else None, 1)[owner]
                except InjectedError:  # retries exhausted, on every rank
                    self.stats["errors"] += 1
                    self._finish(s, req, "error")  # slot stays free
                    continue
                if mine:
                    self.state = _splice_state(self.state, out[1],
                                               s - owner * self._local)
                tok = self._sample(last, req)
                self._agree([tok])
                req.output.append(int(tok))
                # First token out: time-to-first-token for this request.
                t_submit = self._submit_ts.get(req.rid)
                if t_submit is not None:
                    self.registry.histogram("serve.ttft_s").observe(
                        self.clock() - t_submit)
                self.slot_req[s] = req
                self.slot_tokens[s] = int(tok)
                self.slot_age[s] = 0
                self.stats["prefill_tokens"] += len(req.prompt)

    def _prefill_with_retry(self, req: Request, run: bool = True):
        """Prefill this prompt alone (batch=1, spliced into the slot),
        retrying injected failures under the recovery policy; the fault
        injector probed for every attempt whether or not this rank runs
        the prefill (``run``: None where it does not)."""
        attempt = 0
        while True:
            try:
                if (self.fault_injector is not None
                        and self.fault_injector.probe(
                            "request", task=req.rid, site="prefill")):
                    raise InjectedError(
                        f"injected prefill failure: request {req.rid}"
                    )
                if not run:
                    return None
                return self._prefill(self.params, self._prompt(req),
                                     model_api.init_decode_state(
                                         self.cfg, 1, self.max_len,
                                         self.device, self.rules))
            except InjectedError:  # bounded retry
                attempt += 1
                if attempt > self.recovery.max_attempts:
                    raise
                self.stats["retries"] += 1

    def _prompt(self, req: Request) -> dict:
        """The batch of one prompt (the encoder-decoder's frames and the
        VLM's patch embeddings zeros, as the reference's engine makes
        them)."""
        batch = {"tokens": torch.as_tensor(
            np.asarray(req.prompt, np.int32)[None, :], device=self.device)}
        if self.cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (1, self.cfg.enc_frames, self.cfg.d_model),
                dtype=self.cfg.torch_dtype, device=self.device)
        if self.cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (1, self.cfg.n_patches, self.cfg.d_model),
                dtype=self.cfg.torch_dtype, device=self.device)
        return batch

    def _decode_once(self) -> None:
        lo = self._data_index * self._local
        toks = torch.as_tensor(self.slot_tokens[lo:lo + self._local, None],
                               device=self.device)
        attempt = 0
        t0 = self.clock()
        with self.tracer.span("decode_step", stream="serve", cat="compute",
                              step=self.stats["steps"]):
            while True:
                try:
                    if (self.fault_injector is not None
                            and self.fault_injector.probe(
                                "decode", site="decode_step")):
                        raise InjectedError("injected decode-batch failure")
                    logits, state = self._decode(self.params, toks,
                                                 self.state)
                    break
                except InjectedError:  # bounded retry
                    attempt += 1
                    if attempt > self.recovery.max_attempts:
                        raise
                    self.stats["retries"] += 1
            rows = self._gathered(logits[:, -1], self._local)
        self.registry.histogram("serve.decode_step_s").observe(
            self.clock() - t0)
        self.state = state
        self.stats["steps"] += 1
        sampled = {s: self._sample(rows[s], req)
                   for s, req in enumerate(self.slot_req) if req is not None}
        self._agree(list(sampled.values()))
        for s, tok in sampled.items():
            req = self.slot_req[s]
            req.output.append(int(tok))
            self.slot_tokens[s] = int(tok)
            self.slot_age[s] += 1
            self.stats["decode_tokens"] += 1
            if len(req.output) >= req.max_new_tokens:
                self._finish(s, req, "ok")
                continue
            deadline = (req.deadline_steps if req.deadline_steps is not None
                        else self.deadline_steps)
            if deadline is not None and self.slot_age[s] >= deadline:
                # Past its budget: return what we have instead of holding
                # the slot (and the rest of the queue) hostage.
                self.stats["timed_out"] += 1
                self._finish(s, req, "timed_out")

    def _agree(self, tokens: list[int]) -> None:
        """Every rank of the mesh took ``tokens``, or all of them raise."""
        if self._world == 1 or not tokens:
            return
        mine = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        with ranks.use_mesh(self.rules.mesh):
            every = ranks.all_gather(
                mine, tuple(ranks.mesh_sizes(self.rules.mesh)))
        if not bool((every == every[0]).all()):
            raise RuntimeError(f"the ranks sampled different tokens: "
                               f"{every.tolist()}")

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        logits = np.asarray(logits, np.float32)
        if req.temperature <= 0.0:
            return int(logits.argmax())
        p = np.exp((logits - logits.max()) / req.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    """Logits as float32 numpy on the host (waits for the device)."""
    return logits.float().cpu().numpy()


def _splice_state(state: Any, single: Any, slot: int) -> Any:
    """Copy a batch-1 prefill state into batch slot ``slot``, in place.

    Walks dicts and lists leaf by leaf, as the reference's ``jax.tree.map``
    does (the hybrid family's state nests them).  A leaf's batch axis is the
    first one where the state is larger than the batch-1 source (the
    cache's axis 1 behind the layer axis; ``pos``'s axis 0).  Where no axis
    differs (a one-slot engine), the whole leaf is the slot and is copied:
    the reference returns the old leaf there, dropping the prefill's cache
    (ROADMAP Queue C).
    """
    if isinstance(state, dict):
        for name, dst in state.items():
            _splice_state(dst, single[name], slot)
        return state
    if isinstance(state, list):
        for dst, src in zip(state, single, strict=True):
            _splice_state(dst, src, slot)
        return state
    dst, src = state, single
    if dst.ndim == 0:
        return state
    for ax in range(dst.ndim):
        if src.shape[ax] == 1 and dst.shape[ax] != src.shape[ax]:
            dst.narrow(ax, slot, 1).copy_(src.to(dst.dtype))
            return state
    if dst.shape == src.shape:
        dst.copy_(src.to(dst.dtype))
    return state
