"""Control-plane side of the actuation handshake.

The reference actuated by rewriting ``Job.Spec.Parallelism`` and
stopped there (``pkg/autoscaler.go:339-376``): pserver elasticity
needed no world agreement.  Our runtime does — the coordinator caps the
plan at its target world, so after (or before, on scale-down) the
parallelism PUT the control plane must also tell the job's coordinator
the new target (SURVEY.md §7.1 row 4: "Parallelism PUT *plus a
handshake*").  This module resolves a job's coordinator address and
builds the HTTP client the autoscaler/controller use for that POST.

Address resolution defaults to the coordinator Service's cluster DNS
name (``<job>-coordinator:<port>`` — what ``parse_to_coordinator``
renders).  ``EDL_COORD_ADDR_TEMPLATE`` overrides it for environments
without cluster DNS (tests, local runs): a format string with fields
``{name}`` (coordinator/service name), ``{namespace}``, ``{port}``,
``{job}``.
"""

from __future__ import annotations

import os

from edl_tpu_torch.resource.training_job import TrainingJob

#: env override for the coordinator address template
ADDR_TEMPLATE_ENV = "EDL_COORD_ADDR_TEMPLATE"
#: Namespace-qualified Service DNS: the controller watches CRs
#: cluster-wide (``kubectl get -A``), so a bare ``{name}`` would
#: resolve against the controller pod's own namespace and the
#: handshake would silently never reach jobs elsewhere.
DEFAULT_ADDR_TEMPLATE = "{name}.{namespace}:{port}"


def coordinator_address(job: TrainingJob) -> str:
    template = os.environ.get(ADDR_TEMPLATE_ENV, DEFAULT_ADDR_TEMPLATE)
    return template.format(
        name=job.coordinator_name(),
        namespace=job.namespace,
        port=job.spec.port,
        job=job.name,
    )


def make_coord_client(
    job: TrainingJob,
    timeout: float = 2.0,
    retries: int = 1,
    retry_base_delay: float = 0.1,
    retry_deadline: float = None,
):
    """HTTP client for the job's coordinator.  Short timeout + a single
    try by default: the caller runs inside the 5s control loop and must
    tolerate a coordinator that is still scheduling (callers catch
    ``ConnectionError`` and retry on the next tick — the handshake is
    level-triggered, see ``Controller.reconcile_targets``).  When
    ``retries`` > 1 the backoff comes from ``utils.retry.RetryPolicy``
    (jittered, deadline-bounded) so a flapping coordinator can never
    hold a control tick hostage.  ``retry_deadline`` defaults to
    ``retries * (timeout + retry_base_delay)`` — sized so every
    requested attempt can actually run even when each one blocks its
    full connect timeout (a deadline at or below ``timeout`` would
    silently cap timeout-class failures at one attempt)."""
    from edl_tpu_torch.runtime.coord_service import HTTPCoordinator

    if retry_deadline is None:
        retry_deadline = retries * (timeout + retry_base_delay)
    return HTTPCoordinator(
        coordinator_address(job),
        timeout=timeout,
        retries=retries,
        retry_base_delay=retry_base_delay,
        retry_deadline=retry_deadline,
    )
