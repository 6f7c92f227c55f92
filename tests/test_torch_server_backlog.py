"""The serving fronts' listen backlog, on the CPU.

A burst of concurrent clients must all connect before the front's
accept loop takes the first of them.  With socketserver's default
backlog of 5 the kernel drops the SYNs past the sixth, and each dropped
SYN costs its client a 1 s retransmit: 16 concurrent ``/predict``
requests then see a p95 of about a second.  The fronts here are built
but never started, so nothing accepts: a connection succeeds only if
the listen queue holds it.
"""

import socket

import pytest

from edl_tpu_torch.models import get_model
from edl_tpu_torch.serving import ContinuousBatcher, DecodeEngine, ServingServer
from edl_tpu_torch.serving.router import RequestRouter, RouterServer

CLIENTS = 32
CONNECT_TIMEOUT_S = 0.3


class _NoCoordinator:
    def plan(self):
        return None


def _replica_front():
    engine = DecodeEngine(get_model("transformer_lm", tiny=True), device="cpu", max_seqs=2)
    server = ServingServer(ContinuousBatcher(engine), host="127.0.0.1", port=0)
    return server.port, server._server.server_close


def _router_front():
    server = RouterServer(RequestRouter(_NoCoordinator()), host="127.0.0.1", port=0)
    return server.port, server.stop


@pytest.mark.parametrize("front", [_replica_front, _router_front], ids=["replica", "router"])
def test_a_burst_of_clients_connects_before_the_first_accept(front):
    port, close = front()
    socks, refused = [], 0
    try:
        for _ in range(CLIENTS):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.settimeout(CONNECT_TIMEOUT_S)
            socks.append(s)
            try:
                s.connect(("127.0.0.1", port))
            except OSError:
                refused += 1
    finally:
        for s in socks:
            s.close()
        close()
    assert refused == 0, f"{refused} of {CLIENTS} connects did not complete"
