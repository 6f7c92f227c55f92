"""TrainingJob watch source: the informer analog.

The reference watched the CRD through a client-go informer
(``pkg/controller.go:79-108``: ListWatch + NewInformer, resync 0) and
dispatched add/update/delete to the autoscaler.  Kubernetes watches are
just long-polled lists with resourceVersion bookmarks; a plain
poll-and-diff loop provides the same semantics with zero client
dependencies, and the list function is injected so tests, local-sim,
and a real cluster (``KubectlAPI.list_training_jobs``) all drive the
identical controller object.
"""

from __future__ import annotations

import json
import traceback
from typing import Callable, Dict, List

from edl_tpu_torch.resource.training_job import TrainingJob, ValidationError


class TrainingJobWatcher:
    def __init__(
        self,
        list_fn: Callable[[], List[dict]],
        controller,
    ):
        """``list_fn``: returns the current TrainingJob CR manifests
        (dicts).  ``controller``: an ``edl_tpu_torch.controller.Controller``."""
        self._list = list_fn
        self.controller = controller
        self._seen: Dict[str, str] = {}  # name -> canonical spec json
        #: name -> fingerprint of a CR whose add the controller refused
        self._refused: Dict[str, str] = {}

    @staticmethod
    def _fingerprint(manifest: dict) -> str:
        return json.dumps(manifest.get("spec", {}), sort_keys=True)

    @staticmethod
    def _meta_fingerprint(manifest: dict) -> str:
        """Mutable metadata an informer would surface as an update:
        labels AND annotations (a real informer fires on any metadata
        change; resourceVersion-free polling approximates that with the
        two fields users actually edit)."""
        meta = manifest.get("metadata", {}) or {}
        return json.dumps(
            {
                "labels": meta.get("labels", {}),
                "annotations": meta.get("annotations", {}),
            },
            sort_keys=True,
        )

    def poll_once(self) -> int:
        """Diff the listed CRs against the known set; fire on_add /
        on_update / on_delete (ref handler set, ``:110-147``), then a
        **level-triggered** pass: GC workloads whose owning CR is gone.
        The edge-triggered diff alone loses deletions that happened
        while no controller was running (in-memory ``_seen`` state);
        the GC pass converges from observed state regardless of event
        history.  One CR cannot stop the loop for the others: a CR the
        controller refuses (``ValidationError``, or ``NotImplementedError``
        for what the port has not ported) is recorded on that CR and
        marked seen, so it is retried only once its spec changes; any
        other error leaves it unseen, to be retried next poll.  Returns
        the number of events dispatched."""
        current: Dict[str, dict] = {}
        for m in self._list():
            try:
                name = m["metadata"]["name"]
            except (KeyError, TypeError):
                continue
            current[name] = m

        events = 0
        for name, m in current.items():
            fp = self._fingerprint(m) + self._meta_fingerprint(m)
            if fp in (self._seen.get(name), self._refused.get(name)):
                continue
            added = name not in self._seen
            try:
                job = TrainingJob.from_manifest(m)
                if added:
                    self.controller.on_add(job)
                else:
                    self.controller.on_update(job)
            except (ValidationError, NotImplementedError) as e:
                self.controller.refuse(m, e)
                if added:
                    # never reached the controller: its next spec is an add
                    self._refused[name] = fp
                    events += 1
                    continue
            except Exception:
                print(f"[edl] TrainingJob {name}: event failed; retried next poll", flush=True)
                traceback.print_exc()
                continue
            self._refused.pop(name, None)
            events += 1
            self._seen[name] = fp
        for name in [n for n in self._refused if n not in current]:
            del self._refused[name]
        for name in [n for n in self._seen if n not in current]:
            del self._seen[name]
            job = self.controller.jobs.get(name)
            if job is not None:
                self.controller.on_delete(job)
                events += 1
        self.controller.gc_orphans(current.keys())
        return events
