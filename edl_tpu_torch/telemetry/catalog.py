"""The port's metric catalog: every metric name ``edl_tpu_torch`` may
emit, with the same schema as the JAX package's catalog (``type``,
``help``, allowed ``labels``, optional histogram ``buckets``).  It
holds only the names the ported slices set; each later slice adds its
own.  ``KNOWN_EVENT_KINDS`` does the same for flight-recorder event
kinds.  Both are pure literals, so a static checker can
``ast.literal_eval`` them.
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
    # -- chunked prefill, the prefix cache ------------------------------------
    "edl_serve_prefill_chunks_total": {
        "type": "counter",
        "help": "Prefill chunk dispatches: block-aligned prompt slices "
        "fed beside the decode step under the per-iteration token "
        "budget.",
        "labels": (),
    },
    "edl_serve_prefill_tokens_total": {
        "type": "counter",
        "help": "Prompt tokens prefilled through chunk dispatches "
        "(true tokens, bucket padding excluded).",
        "labels": (),
    },
    "edl_serve_prefill_queued_tokens": {
        "type": "gauge",
        "help": "Prompt tokens still awaiting prefill (queued prompts "
        "+ the chunk FIFO's remaining work): the chunked-admission "
        "backpressure signal.",
        "labels": (),
    },
    "edl_serve_prefill_stall_seconds": {
        "type": "histogram",
        "help": "Time one scheduler iteration's admission/prefill work "
        "held up an already-running decode batch (observed only on "
        "iterations where both sides were live).",
        "buckets": (
            0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
            0.25, 0.5, 1.0, 2.5,
        ),
        "labels": (),
    },
    "edl_serve_kv_used_bytes_per_device": {
        "type": "gauge",
        "help": "KV bytes the serving device holds for blocks owned by "
        "live sequences (owned blocks times the bytes of one block).",
        "labels": (),
    },
    "edl_serve_prefix_hits_total": {
        "type": "counter",
        "help": "Admissions whose prompt matched a published prefix "
        "run in the KV prefix cache: the sequence skipped straight to "
        "its first cold block.",
        "labels": (),
    },
    "edl_serve_prefix_misses_total": {
        "type": "counter",
        "help": "Admissions that walked the prefix chain and matched "
        "nothing (prompts too short to span one block are not "
        "counted: they are uncacheable, not missed).",
        "labels": (),
    },
    "edl_serve_prefix_blocks_reused_total": {
        "type": "counter",
        "help": "KV blocks claimed by a refcount instead of being "
        "allocated and prefilled (each is one block of prompt compute "
        "the replica never paid).",
        "labels": (),
    },
    "edl_serve_prefix_evictions_total": {
        "type": "counter",
        "help": "Refcount-0 cached prefix blocks evicted back to the "
        "free list (LRU, under allocation pressure or a chaos "
        "serve.prefix.evicted trip).",
        "labels": (),
    },
    "edl_serve_prefix_hit_ratio": {
        "type": "gauge",
        "help": "Running hits / (hits + misses) of the prefix cache "
        "since the batcher started (invalidations do not reset it).",
        "labels": (),
    },
    # -- the checkpoint-backed replica: hot swap, drain ------------------------
    "edl_serve_swap_rejected_total": {
        "type": "counter",
        "help": "Candidate checkpoints rejected at a load or hot-swap "
        "attempt (CRC verification failed, unreadable durable spill, "
        "or leaves that do not fit the model): the engine keeps "
        "serving the old weights.",
        "labels": (),
    },
    "edl_serve_draining": {
        "type": "gauge",
        "help": "Per-replica drain state: 0 serving, 1 draining "
        "(admission closed, in-flight finishing), 2 drained "
        "(deregistered, ready to exit).",
        "labels": ("replica",),
    },
    "edl_serve_drains_total": {
        "type": "counter",
        "help": "Graceful drains started on this replica (POST /drain "
        "or SIGTERM).",
        "labels": (),
    },
    "edl_serve_drain_seconds": {
        "type": "histogram",
        "help": "Seconds from admission close to drained (every "
        "in-flight single-shot request and decode sequence finished, "
        "KV blocks freed, replica deregistered).",
        "labels": (),
    },
    # -- the elastic training runtime (ElasticTrainer, stager, ledger) -------
    "edl_steps_total": {
        "type": "counter",
        "help": "Completed train steps (replayed steps count again).",
        "labels": (),
    },
    "edl_step_seconds": {
        "type": "histogram",
        "help": "Wall-clock seconds per train step.",
        "labels": (),
    },
    "edl_pipeline_depth": {
        "type": "gauge",
        "help": "Configured steady-state pipeline depth (max in-flight "
        "steps; 0 = synchronous per-step host<->device sync).",
        "labels": (),
    },
    "edl_batch_stage_seconds": {
        "type": "histogram",
        "help": "Seconds to assemble one global batch on the host and "
        "place it on device (the work the pipeline's background "
        "stager overlaps with compute).",
        "labels": (),
    },
    "edl_device_wait_seconds": {
        "type": "histogram",
        "help": "Seconds the host blocked waiting on a step's device "
        "metrics at harvest (the lag-deferred loss fetch).",
        "labels": (),
    },
    "edl_resizes_total": {
        "type": "counter",
        "help": "Resize barriers completed, by gracefulness and how "
        "state was restored.",
        "labels": ("graceful", "source"),
    },
    "edl_resize_seconds": {
        "type": "histogram",
        "help": "End-to-end resize-window seconds.",
        "labels": (),
    },
    "edl_resize_phase_seconds": {
        "type": "histogram",
        "help": "Per-phase resize-window seconds (flush / "
        "world_formation / restore / flush_bg ... — the "
        "ResizeEvent.phase_seconds keys).",
        "labels": ("phase",),
    },
    "edl_replayed_steps_total": {
        "type": "counter",
        "help": "Steps re-run after a non-graceful resize fell back to "
        "the last interval checkpoint.",
        "labels": (),
    },
    "edl_world_breaks_total": {
        "type": "counter",
        "help": "Live process groups abandoned after a peer died "
        "mid-collective.",
        "labels": (),
    },
    # -- host-DRAM checkpoints and the restore transfer ----------------------
    "edl_checkpoint_saves_total": {
        "type": "counter",
        "help": "Checkpoint saves by kind (async interval save vs "
        "synchronous resize flush).",
        "labels": ("kind",),
    },
    "edl_checkpoint_bytes_total": {
        "type": "counter",
        "help": "Bytes captured into host-DRAM checkpoints.",
        "labels": ("kind",),
    },
    "edl_checkpoint_save_seconds": {
        "type": "histogram",
        "help": "Seconds to materialize a checkpoint (async save "
        "thread / flush device-to-host phase).",
        "labels": ("kind",),
    },
    "edl_transfer_bytes_sent_total": {
        "type": "counter",
        "help": "Restore-transfer bytes this process sent.",
        "labels": (),
    },
    "edl_transfer_bytes_received_total": {
        "type": "counter",
        "help": "Restore-transfer bytes this process received.",
        "labels": (),
    },
    "edl_transfer_chunks_total": {
        "type": "counter",
        "help": "Restore-transfer chunks received.",
        "labels": (),
    },
    "edl_transfer_leaves_skipped_total": {
        "type": "counter",
        "help": "Leaves skipped because local bytes already matched "
        "the source digest (the delta-restore win).",
        "labels": (),
    },
    "edl_transfer_seconds": {
        "type": "histogram",
        "help": "Restore-transfer engine seconds (agreement + wire).",
        "labels": (),
    },
    # -- coordinator client retries ------------------------------------------
    "edl_retry_attempts_total": {
        "type": "counter",
        "help": "Transient failures absorbed by RetryPolicy (one per "
        "failed attempt that was retried).",
        "labels": ("op",),
    },
    "edl_retry_giveups_total": {
        "type": "counter",
        "help": "RetryPolicy exhaustions (GiveUpError raised).",
        "labels": ("op",),
    },
    "edl_chaos_injections_total": {
        "type": "counter",
        "help": "Chaos faults actually delivered, by injection point.",
        "labels": ("point",),
    },
    # -- data-plane step agreement (step bus, watchdog) ----------------------
    "edl_consensus_words_total": {
        "type": "counter",
        "help": "Step-bus control words harvested (one per train step "
        "on multi-member worlds).",
        "labels": (),
    },
    "edl_consensus_votes_total": {
        "type": "counter",
        "help": "Stop votes this member cast on the step bus (one per "
        "observed retarget).",
        "labels": (),
    },
    "edl_consensus_stop_step": {
        "type": "gauge",
        "help": "Last data-plane-agreed stop step (the boundary every "
        "member leaves the old world at).",
        "labels": (),
    },
    "edl_consensus_step_skew_buckets": {
        "type": "gauge",
        "help": "Timing-lane bucket spread between the slowest and "
        "fastest member in the last harvested word (log2 buckets).",
        "labels": (),
    },
    "edl_consensus_stragglers_total": {
        "type": "counter",
        "help": "Words where one member's timing bucket exceeded the "
        "fastest by the straggler spread, by process rank.",
        "labels": ("rank",),
    },
    "edl_consensus_watchdog_trips_total": {
        "type": "counter",
        "help": "Collective-watchdog deadline expiries (wedged "
        "step/control futures buried via broken-world recovery).",
        "labels": (),
    },
    "edl_consensus_quiesce_seconds": {
        "type": "histogram",
        "help": "Seconds from observing a retarget to quiescing at the "
        "agreed stop step (drain complete, ready to leave the world).",
        "labels": (),
    },
    # -- goodput ledger -------------------------------------------------------
    "edl_goodput_seconds_total": {
        "type": "counter",
        "help": "Wall-clock seconds this process spent in each "
        "training state (stepping / staging_stalled / resizing[:phase] "
        "/ holding / replaying / broken) — the honest decomposition "
        "behind the goodput fraction the autoscaler reads back.",
        "labels": ("state",),
    },
    "edl_goodput_frac": {
        "type": "gauge",
        "help": "Fraction of attributed wall-clock this process spent "
        "actually stepping (stepping / total ledger seconds).",
        "labels": (),
    },
    # -- live KV migration and the dispatch watchdog --------------------------
    "edl_serve_migrations_total": {
        "type": "counter",
        "help": "Sequences handed to a survivor at drain/preemption, by "
        "outcome: ok (KV blocks moved, decode resumed "
        "mid-generation), fallback (push failed somewhere on the "
        "ladder, re-prefilled cold on the survivor), cold "
        "(half-prefilled or queued sequence requeued as a cold "
        "prompt), failed (survivor unusable, sequence readmitted "
        "locally and drained by waiting).",
        "labels": ("outcome",),
    },
    "edl_serve_migrations_bytes_total": {
        "type": "counter",
        "help": "KV-cache bytes pushed to survivors over the chunked "
        "migration stream (filled blocks only, K and V planes).",
        "labels": (),
    },
    "edl_serve_migrate_seconds": {
        "type": "histogram",
        "help": "Seconds from sequence freeze to the survivor's import ack "
        "(device->host gather + chunked TCP push + dest pool "
        "scatter) — the per-sequence unit of O(KV bytes) drain "
        "latency.",
        "labels": (),
    },
    "edl_serve_dispatch_wedged_total": {
        "type": "counter",
        "help": "Serving dispatches (prefill / chunk / decode) that missed "
        "the dispatch watchdog deadline and were recovered via pool "
        "rebuild + cache-epoch re-prefill instead of hanging the "
        "worker thread.",
        "labels": (),
    },
    # -- the request router ---------------------------------------------------
    "edl_route_requests_total": {
        "type": "counter",
        "help": "Requests the router resolved, by outcome: ok (served, "
        "possibly after absorbed retries), exhausted (per-request "
        "retry budget spent -> typed RetryBudgetExhausted), error "
        "(non-retryable upstream reply passed through).",
        "labels": ("outcome",),
    },
    "edl_route_retries_total": {
        "type": "counter",
        "help": "Per-attempt failures the router absorbed invisibly (the "
        "client never saw them), by what the backend said: "
        "queue_full (429 back-off-here), draining (503 "
        "go-elsewhere), refused (connection refused/reset = dead "
        "replica), error (other 5xx/transport failure).",
        "labels": ("reason",),
    },
    "edl_route_steers_total": {
        "type": "counter",
        "help": "Admissions steered off a draining replica BEFORE it could "
        "503 them (the router consumed the drain intent / healthz "
        "draining bit first).",
        "labels": (),
    },
    "edl_route_ejections_total": {
        "type": "counter",
        "help": "Replicas ejected from rotation on consecutive-failure "
        "passive health (re-admission is by active probe only).",
        "labels": (),
    },
    "edl_route_readmits_total": {
        "type": "counter",
        "help": "Ejected replicas re-admitted after an active /healthz "
        "probe came back ok and not draining.",
        "labels": (),
    },
    "edl_route_redrives_total": {
        "type": "counter",
        "help": "In-flight /generate streams cut by a replica failure and "
        "re-driven against a survivor: resume (same weights step -> "
        "greedy continuation from the emitted prefix, no token "
        "duplicated or dropped) or restart (weights skew -> restart "
        "event voids prior tokens, the batcher's hot-swap "
        "contract).",
        "labels": ("outcome",),
    },
    "edl_route_affinity_total": {
        "type": "counter",
        "help": "Prefix-affinity consults on /generate admissions: hit "
        "(routed to the replica already holding the prompt's cached "
        "prefix blocks) or miss (no affinity known, or the affine "
        "replica was unroutable/overloaded — advisory only, never "
        "correctness-bearing).",
        "labels": ("outcome",),
    },
    "edl_route_backends": {
        "type": "gauge",
        "help": "Routable-backend census by health state (healthy / "
        "draining / ejected), from the router's last plan sync.",
        "labels": ("state",),
    },
    # -- multi-job fleet market (edl_tpu_torch.fleet) ------------------------
    "edl_fleet_chips_total": {
        "type": "gauge",
        "help": "GPUs in the fleet arbiter's inventory.",
        "labels": (),
    },
    "edl_fleet_chips_free": {
        "type": "gauge",
        "help": "Chips left unallocated after the last market fixed "
        "point.",
        "labels": (),
    },
    "edl_fleet_chips_allocated": {
        "type": "gauge",
        "help": "Chips the market currently allocates to each bidder "
        "(training job or serving fleet).",
        "labels": ("job",),
    },
    "edl_fleet_target_units": {
        "type": "gauge",
        "help": "Decided unit count (trainer replicas / serving "
        "replicas) per bidder after the last fixed point.",
        "labels": ("job",),
    },
    "edl_fleet_decisions_total": {
        "type": "counter",
        "help": "Per-job fleet decision entries journaled (one per "
        "bidder per arbiter tick).",
        "labels": (),
    },
    "edl_fleet_preemptions_total": {
        "type": "counter",
        "help": "Preemption steps the arbiter took (a trainer shed "
        "one legal size to cover a serving SLO requirement), by "
        "victim job.",
        "labels": ("job",),
    },
    "edl_fleet_unmet_demand_chips": {
        "type": "gauge",
        "help": "Chips a serving fleet's SLO requirement is short "
        "even after exhausting every preemptible trainer (0 = SLO "
        "demand covered).",
        "labels": ("job",),
    },
    # -- telemetry reports, spans, the flight recorder's spill ----------------
    "edl_telemetry_reports_total": {
        "type": "counter",
        "help": "Telemetry snapshots shipped to the coordinator (by "
        "trainers and serving replicas).",
        "labels": (),
    },
    "edl_span_seconds": {
        "type": "histogram",
        "help": "Named span durations; span names match the utils.profiling "
        "trace annotations so traces and metrics correlate by name.",
        "labels": ("span",),
    },
    # -- the autoscaler's control loop (autoscaler.scaler) --------------------
    "edl_autoscaler_ticks_total": {
        "type": "counter",
        "help": "Autoscaler decision cycles (run_once with jobs).",
        "labels": (),
    },
    "edl_autoscaler_actuations_total": {
        "type": "counter",
        "help": "Autoscaler actuations applied, by direction.",
        "labels": ("direction",),
    },
    "edl_observed_step_rate": {
        "type": "gauge",
        "help": "Observed cluster step rate (steps/s) from merged "
        "trainer telemetry — the goodput signal the autoscaler logs "
        "into its decision trace.",
        "labels": ("job",),
    },
    "edl_observed_resize_cost_seconds": {
        "type": "gauge",
        "help": "Mean observed resize cost (seconds) from merged "
        "trainer telemetry.",
        "labels": ("job",),
    },
    # -- the coordinator snapshot as gauges (its /metrics) --------------------
    "edl_generation": {
        "type": "gauge",
        "help": "Coordinator plan generation.",
        "labels": (),
    },
    "edl_world_size": {
        "type": "gauge",
        "help": "Active world size of the current plan.",
        "labels": (),
    },
    "edl_members": {
        "type": "gauge",
        "help": "Registered live members (active + standby).",
        "labels": (),
    },
    "edl_standby_members": {
        "type": "gauge",
        "help": "Registered members beyond the active world.",
        "labels": (),
    },
    "edl_target_world": {
        "type": "gauge",
        "help": "Actuation target world size.",
        "labels": (),
    },
    "edl_prewarm_world": {
        "type": "gauge",
        "help": "Advisory prewarm hint (0 = none).",
        "labels": (),
    },
    "edl_target_steps": {
        "type": "gauge",
        "help": "Steps after which the job completes (0 = open-ended).",
        "labels": (),
    },
    "edl_latest_checkpoint_step": {
        "type": "gauge",
        "help": "Latest durable checkpoint step the coordinator knows.",
        "labels": (),
    },
    "edl_plan_rebuilds": {
        "type": "gauge",
        "help": "Plan rebuilds (generation bumps) since coordinator start.",
        "labels": (),
    },
    "edl_completed": {
        "type": "gauge",
        "help": "1 once a trainer reported the job complete.",
        "labels": (),
    },
    "edl_completed_step": {
        "type": "gauge",
        "help": "Step at which completion was reported (-1 = none).",
        "labels": (),
    },
    # -- flight recorder ---------------------------------------------------
    "edl_flight_spill_dropped_total": {
        "type": "counter",
        "help": "Flight-recorder JSONL spill writes dropped (write "
        "failed, or spill temporarily disabled after a failure).",
        "labels": (),
    },
}

# Every flight-recorder event kind the port journals: the keys are a
# subset of the JAX package's ``KNOWN_EVENT_KINDS``, and a test holds
# every literal ``.record("<kind>"`` of the port to them.  Free-form
# kinds are what make merged cluster timelines unreadable.  The fabric
# kinds come with their slice.  Pure literal.
KNOWN_EVENT_KINDS = {
    # training / resize lifecycle (runtime.elastic)
    "resize": "a resize barrier completed on this member",
    "step.first": "first harvested step of a fresh generation",
    "world.broken": "live process group abandoned mid-collective",
    "prewarm.hint": "a coordinator prewarm hint accepted (nothing to warm)",
    "profile.window": "a bounded device-trace window opened/closed",
    # checkpoints / transfer
    "checkpoint.save": "checkpoint materialization submitted",
    "transfer": "streaming restore-transfer summary",
    # control plane (runtime.coordinator)
    "coord.plan": "coordinator plan rebuild (generation bump)",
    "coord.evict": "heartbeat-lease eviction",
    "coord.telemetry": "trainer telemetry report ingested",
    "coord.world_acked": "every planned member acked the generation",
    # consensus
    "consensus.vote": "stop vote cast on the step bus",
    "consensus.stop": "stop agreement learned from a harvested word",
    "consensus.quiesce": "member drained at the agreed stop boundary",
    "consensus.straggler": "timing-lane straggler transition",
    "consensus.watchdog": "collective watchdog deadline expired",
    # resilience plumbing
    "retry": "transient failure absorbed by RetryPolicy",
    "retry.giveup": "RetryPolicy exhausted (GiveUpError)",
    "chaos": "a scheduled fault was actually delivered",
    # autoscaler
    "autoscaler.decision": "one goodput-annotated decision-log entry",
    # multi-job fleet market
    "fleet.decision": "one per-job fleet-arbiter decision entry",
    "fleet.preempt": "a trainer stepped down to cover a serving SLO",
    # inference serving
    "serve.warm": "a serving model call run by warm()",
    "serve.swap": "a newer verified checkpoint hot-swapped in",
    "serve.swap.rejected": "a hot-swap candidate failed verification",
    "serve.replica": "a serving replica registered / took traffic",
    "serve.restart": "a hot swap re-prefilled in-flight sequences",
    "serve.drain": "a replica drain started / completed",
    "serve.watchdog": "a serving dispatch missed the watchdog deadline",
    "serve.migrate": "a live KV sequence moved (or fell back) at drain",
    "serve.prefix": "the KV prefix cache invalidated / rejected / evicted",
    # fleet front door: the request router
    "route.steer": "new work steered off a draining replica pre-503",
    "route.eject": "a replica left rotation on passive health",
    "route.readmit": "an active probe re-admitted an ejected replica",
    "route.redrive": "a cut /generate stream re-driven on a survivor",
    "route.exhausted": "a request spent its whole retry budget",
    # recorder-internal default for ingested events missing a kind
    "event": "unclassified ingested event",
}
