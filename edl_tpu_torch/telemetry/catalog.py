"""The port's metric catalog: every metric name ``edl_tpu_torch`` may
emit, with the same schema as the JAX package's catalog (``type``,
``help``, allowed ``labels``, optional histogram ``buckets``).  It
holds only the names the ported slices set; each later slice adds its
own.  Kept a pure literal so a static checker can ``ast.literal_eval``
it.
"""

CATALOG = {
    # -- inference serving: single-shot /predict ------------------------------
    "edl_serve_requests_total": {
        "type": "counter",
        "help": "Serving requests by terminal status (ok / rejected "
        "on backpressure / expired past deadline / error).",
        "labels": ("status",),
    },
    "edl_serve_batches_total": {
        "type": "counter",
        "help": "Micro-batches the continuous batcher dispatched.",
        "labels": (),
    },
    "edl_serve_examples_total": {
        "type": "counter",
        "help": "Examples served (request rows, padding excluded).",
        "labels": (),
    },
    "edl_serve_queue_depth": {
        "type": "gauge",
        "help": "Requests waiting in the admission queue (the "
        "backpressure / autoscaling signal).",
        "labels": (),
    },
    "edl_serve_latency_seconds": {
        "type": "histogram",
        "help": "End-to-end request latency (admission to response).",
        "labels": (),
    },
    "edl_serve_batch_occupancy": {
        "type": "histogram",
        "help": "Real rows / padded bucket rows per dispatched "
        "micro-batch (1.0 = no padding waste).",
        "buckets": (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        "labels": (),
    },
    "edl_serve_hot_swaps_total": {
        "type": "counter",
        "help": "Weight sets installed after the first (generation-"
        "keyed; an in-flight batch never sees torn weights).",
        "labels": (),
    },
    "edl_serve_weights_step": {
        "type": "gauge",
        "help": "Training step of the weights currently serving.",
        "labels": (),
    },
    "edl_serve_kv_pool_bytes_per_device": {
        "type": "gauge",
        "help": "KV pool bytes the serving device holds (both planes).",
        "labels": (),
    },
    # -- autoregressive decode serving (DecodeEngine + token batcher) --------
    "edl_serve_tokens_total": {
        "type": "counter",
        "help": "Generated tokens emitted by the decode path (prefill "
        "first tokens + decode-iteration tokens).",
        "labels": (),
    },
    "edl_serve_prefills_total": {
        "type": "counter",
        "help": "Sequences prefilled (one bucketed prompt forward per "
        "admitted request; re-prefills after a weight swap count "
        "again).",
        "labels": (),
    },
    "edl_serve_decode_iterations_total": {
        "type": "counter",
        "help": "Per-token decode iterations dispatched (one batched "
        "decode call each).",
        "labels": (),
    },
    "edl_serve_restarts_total": {
        "type": "counter",
        "help": "In-flight sequences re-prefilled because new weights "
        "were installed mid-generation (their partial output is void - "
        "one sequence never mixes weight generations).",
        "labels": (),
    },
    "edl_serve_decode_queue_depth": {
        "type": "gauge",
        "help": "Generate requests waiting for a decode slot/KV blocks.",
        "labels": (),
    },
    "edl_serve_active_sequences": {
        "type": "gauge",
        "help": "Sequences currently in the running decode batch.",
        "labels": (),
    },
    "edl_serve_kv_occupancy": {
        "type": "gauge",
        "help": "Fraction of the paged KV pool's usable blocks "
        "currently owned by live sequences.",
        "labels": (),
    },
    "edl_serve_ttft_seconds": {
        "type": "histogram",
        "help": "Time to first token: request enqueue to the first "
        "generated token.",
        "labels": (),
    },
    "edl_serve_intertoken_seconds": {
        "type": "histogram",
        "help": "Gap between consecutive tokens of one sequence "
        "(decode-iteration cadence as the client experiences it).",
        "buckets": (
            0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
            0.25, 0.5, 1.0, 2.5,
        ),
        "labels": (),
    },
}
