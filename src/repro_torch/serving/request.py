"""Request record flowing through the serving stack, plus the
structure-of-arrays ingest columns the zero-allocation hot path reads.

Port of `repro.serving.request` (numpy). The ingest embedding memo
(`RequestColumns.ensure_embeddings`) calls the port's encoder
(`repro_torch.estimators.embedding.SentenceEncoder`), which returns
float32 numpy rows from whatever device it runs on.

`RequestColumns` is built once, at workload-generation time: everything
the scheduler's decision needs per request — token ids, token lengths,
`len_in`, budgets, and (lazily, the first time a scheduler sees the
stream) the prompt embeddings — lives in columnar arrays, and each
`Request` carries its row index. A steady-state decision batch is then a
handful of vectorized gathers into preallocated staging buffers instead
of four Python list comprehensions and fresh numpy allocations per
batch (the host-path bottleneck isolated by the data-parallel
load-balancing line of work; see README "hot path anatomy").

Prompts repeat across requests (traces cycle a finite prompt set), so
the token matrix and the embedding column are per *unique prompt*, with
a (N,) `prompt_row` indirection; per-request columns hold only scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .world import Prompt


class RequestColumns:
    """Columnar (SoA) view over a request stream.

    Per unique prompt (P rows): `tokens` (P, L) int32 zero-padded with
    L the longest prompt (full width — the ENCODER applies its own
    `max_len` cap at encode time, so the columns never silently
    truncate what a wider-context encoder would read), `tok_len` (P,),
    and — once `ensure_embeddings` has run — `emb` (P, E) float32. Per
    request (N rows): `prompt_row` (N,) int32 into the prompt axis,
    `len_in` (N,) float64, `budget` (N,) float64 with nan =
    unconstrained (matching the AoS marshaling dtypes exactly, so
    columnar and legacy staging are bitwise-identical).
    """

    def __init__(self, tokens: np.ndarray, tok_len: np.ndarray,
                 prompt_row: np.ndarray, len_in: np.ndarray,
                 budget: np.ndarray):
        self.tokens = tokens
        self.tok_len = tok_len
        self.prompt_row = prompt_row
        self.len_in = len_in
        self.budget = budget
        self.emb: Optional[np.ndarray] = None       # (P, E) float32
        self._prefix_sig: Optional[np.ndarray] = None  # (P, SIG_WIDTH)
        self._toks_padded: Optional[np.ndarray] = None  # pow2-width cache
        self._emb_partial = None    # [out, rows_done] resume bookkeeping

    @property
    def n(self) -> int:
        return len(self.prompt_row)

    @property
    def prefix_sig(self) -> np.ndarray:
        """(P, SIG_WIDTH) int32 rolling-hash prefix signatures per
        unique prompt (lazy, memoized like `emb`). Same masked hash as
        `affinity.prompt_signatures`, so the scoring path (columnar
        gathers) and the dispatch path (per-prompt) agree exactly."""
        if self._prefix_sig is None:
            from .affinity import prefix_signatures
            self._prefix_sig = prefix_signatures(self.tokens,
                                                 self.tok_len)
        return self._prefix_sig

    @staticmethod
    def from_requests(reqs: Sequence["Request"], stamp: bool = True
                      ) -> "RequestColumns":
        """Build the columns for a request stream (ingest time — the one
        place per-request Python work is allowed) and, with `stamp`,
        mark each request with its row. Prompts are deduplicated by
        identity. `stamp=False` builds ephemeral columns for a one-off
        batch WITHOUT touching the requests — requests that already
        belong to a stream keep their stream's cols/row (and their
        budget write-through target)."""
        slot: Dict[int, int] = {}
        prompts: List[Prompt] = []
        prompt_row = np.empty(len(reqs), np.int32)
        len_in = np.empty(len(reqs), np.float64)
        budget = np.empty(len(reqs), np.float64)
        for i, r in enumerate(reqs):
            key = id(r.prompt)
            j = slot.get(key)
            if j is None:
                j = slot[key] = len(prompts)
                prompts.append(r.prompt)
            prompt_row[i] = j
            len_in[i] = r.prompt.len_in
            budget[i] = np.nan if r.budget is None else r.budget
        from ..estimators.embedding import pad_tokens
        L = int(max((len(p.tokens) for p in prompts), default=1))
        tokens = pad_tokens([p.tokens for p in prompts], L)
        tok_len = np.array([len(p.tokens) for p in prompts], np.int64)
        cols = RequestColumns(tokens, tok_len, prompt_row, len_in, budget)
        if stamp:
            for i, r in enumerate(reqs):
                r.cols = cols
                r.row = i
        return cols

    @staticmethod
    def for_batch(reqs: Sequence["Request"], encoder):
        """(cols, rows) for a decision batch, embeddings guaranteed: the
        batch's shared stream columns when it has them, else ephemeral
        non-stamping columns. The single fallback for direct/legacy
        callers reaching a columnar decision path."""
        cols, rows = batch_columns(reqs)
        if cols is None:
            cols = RequestColumns.from_requests(reqs, stamp=False)
            rows = np.arange(len(reqs), dtype=np.int64)
        cols.ensure_embeddings(encoder)
        return cols, rows

    def ensure_embeddings(self, encoder) -> "RequestColumns":
        """Embed the unique prompts once (chunked, pow2-padded so the
        encoder jit cache stays warm across streams). Embedding depends
        only on the prompt, and the masked-pooling encoder is bitwise
        stable under batch/length padding, so precomputing here is pure
        memoization of the per-batch encode the staged path used to run
        inside every decision. Lengths are capped at the encoder's own
        `max_len` — the same truncation the per-batch encode applies."""
        if self.emb is not None:
            return self
        from ..core.decision import bucket_pow2
        P = len(self.tokens)
        cap_len = np.minimum(self.tok_len, encoder.max_len)
        # pow2-pad the token WIDTH as well as the batch: encode slices
        # width at its own max_len before tracing, so streams whose
        # longest prompts differ still land on O(log max_len) compiled
        # encoder shapes instead of one per distinct stream width.
        # The padded matrix is built ONCE and cached — re-entry (a
        # resume after a mid-chunk encoder failure) must not
        # concatenate a fresh zero block per call.
        toks_all = self._toks_padded
        if toks_all is None:
            toks_all = self.tokens
            Wb = bucket_pow2(toks_all.shape[1])
            if Wb != toks_all.shape[1]:
                toks_all = np.concatenate(
                    [toks_all,
                     np.zeros((P, Wb - toks_all.shape[1]),
                              toks_all.dtype)], axis=1)
            self._toks_padded = toks_all
        # all-or-nothing: `self.emb` is assigned only after EVERY chunk
        # encoded, so a mid-chunk raise can never expose garbage rows.
        # Partial progress is kept in `_emb_partial` — a retry resumes
        # from the first unencoded row instead of recomputing (or
        # worse, serving) the rows a failed pass left behind.
        if (self._emb_partial is None
                or self._emb_partial[0].shape[1] != encoder.dim):
            self._emb_partial = [np.empty((P, encoder.dim), np.float32),
                                 0]
        out, done = self._emb_partial
        chunk = 256
        for i in range(done, P, chunk):
            toks = toks_all[i:i + chunk]
            lens = cap_len[i:i + chunk]
            n = len(toks)
            pad = bucket_pow2(n) - n
            if pad:
                toks = np.concatenate(
                    [toks, np.zeros((pad,) + toks.shape[1:], toks.dtype)])
                lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
            out[i:i + n] = encoder.encode(toks, lens)[:n]
            self._emb_partial[1] = i + n
        self.emb = out
        self._emb_partial = None
        return self


def batch_columns(reqs: Sequence["Request"]):
    """(cols, rows (R,) int64) when every request in the batch shares
    one `RequestColumns`, else (None, None). This walks the batch in
    Python, so it is for direct/legacy callers only — the scheduler
    tracks the shared-columns invariant incrementally at enqueue time
    and never calls it on the steady-state path."""
    c0 = reqs[0].cols if reqs else None
    if c0 is None:
        return None, None
    for r in reqs:
        # the upper bound matters as much as the identity check: a
        # request stamped by a DIFFERENT (larger) stream that was
        # re-pointed at these columns would otherwise gather another
        # request's tokens/embedding row — or read out of bounds
        if r.cols is not c0 or not (0 <= r.row < c0.n):
            return None, None
    return c0, np.fromiter((r.row for r in reqs), np.int64,
                           count=len(reqs))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Prompt
    arrival: float
    true_quality: np.ndarray       # (M,) hidden from the scheduler
    true_length: np.ndarray        # (M,) hidden from the scheduler
    budget: Optional[float] = None  # USD, optional per-request cost budget
    tenant: Optional[str] = None   # tenant class in composite scenarios
    priority: int = 0              # SLO class for shedding (0 = premium)

    # SoA ingest columns (set by RequestColumns.from_requests)
    cols: Optional[RequestColumns] = dataclasses.field(
        default=None, repr=False, compare=False)
    row: int = -1

    def __setattr__(self, name, value):
        # keep the ingest columns coherent when a caller edits a
        # columnar field on the object after ingest (tests and benches
        # stamp budgets onto already-built streams) — the decision path
        # reads the columns, not the objects
        object.__setattr__(self, name, value)
        if name == "budget":
            cols = getattr(self, "cols", None)
            if cols is not None and self.row >= 0:
                cols.budget[self.row] = np.nan if value is None else value

    # filled at dispatch
    instance: Optional[str] = None
    model_idx: Optional[int] = None
    dispatch_time: Optional[float] = None
    pred_len: Optional[float] = None
    max_tokens: Optional[int] = None
    # matched-prefix fraction against the target instance's sketch at
    # submit time (serving.affinity): drives the prefill discount in
    # `Instance._admit` and the cache_hit_rate metric
    prefix_hit: float = 0.0

    # fault-tolerant lifecycle (the reference's serving.recovery). `arrival` is
    # the SCHEDULING arrival — a requeued retry re-enters admission with
    # a fresh arrival so batch-wait accounting charges the retry, not
    # the whole outage — while `first_arrival` keeps the true ingest
    # time so e2e/ttft metrics charge the full client-visible latency.
    first_arrival: Optional[float] = None
    attempt: int = 0               # dispatch attempts beyond the first
    hedges: int = 0                # hedged re-dispatches taken
    wasted_tokens: int = 0         # tokens generated then thrown away
    #                                (failed mid-decode or hedge loser)

    # filled at completion
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    tokens_out: int = 0
    exhausted: bool = False        # stopped by budget early-stop/clamp
    failed: bool = False
    shed: bool = False             # refused at admission by overload control

    # scheduler-side accounting (off-instance residual decomposition)
    sched_compute: float = 0.0
    sched_batch_wait: float = 0.0
    sched_stats_fetch: float = 0.0
    router_queue_wait: float = 0.0

    def __post_init__(self):
        if self.first_arrival is None:
            self.first_arrival = self.arrival

    def requeue(self, t: float):
        """Reset dispatch state for a retry re-entering admission: the
        request looks freshly arrived to the scheduler (arrival = now,
        clean dispatch/completion fields) while `first_arrival` keeps
        charging the true end-to-end clock."""
        self.attempt += 1
        self.arrival = t
        self.instance = None
        self.model_idx = None
        self.dispatch_time = None
        self.pred_len = None
        self.max_tokens = None
        self.prefix_hit = 0.0
        self.first_token_time = None
        self.tokens_out = 0
        self.exhausted = False
        self.failed = False

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        start = (self.first_arrival if self.first_arrival is not None
                 else self.arrival)
        return self.finish_time - start

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        start = (self.first_arrival if self.first_arrival is not None
                 else self.arrival)
        return self.first_token_time - start

    def served_quality(self) -> float:
        """Quality of the actually-served text: the routing-decision
        lookup value, discounted when the response was truncated
        (budget exhaustion -> near-empty answers score near zero)."""
        if self.model_idx is None or self.finish_time is None:
            return 0.0
        q = float(self.true_quality[self.model_idx])
        need = float(self.true_length[self.model_idx])
        if self.tokens_out + 0.5 >= need or need <= 0:
            return q
        frac = self.tokens_out / need
        return q * frac ** 0.7

    def lookup_quality(self) -> float:
        """The routing-decision metric (§4.2): offline per-(prompt, model)
        score of the chosen model, independent of truncation."""
        if self.model_idx is None:
            return 0.0
        return float(self.true_quality[self.model_idx])
