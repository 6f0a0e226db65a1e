"""Cross-cloud transport cost models — the paper's §3.2 protocol comparison
(the port's own copy of the reference's ``core/protocols.py``; plain Python).

The trainer runs on one card and speaks no wire protocol, so the paper's
"which transport for cross-cloud sync?" question is answered with an
analytic per-transfer model applied to the *measured* sync payload
(``Compressor.bytes_per_sync``).

Model per transfer of B bytes over a link (latency ℓ, bandwidth W, loss p):

    t = handshake + ℓ + B / (W·η) + stall(p, B)

* TCP/gRPC: HTTP/2 over TCP — 1 connection handshake amortized, but
  head-of-line blocking couples all multiplexed streams to one loss event:
  stall ≈ p · (B/MSS) · RTT across the whole connection.
* QUIC: 0-RTT resumption, per-stream loss isolation: only the lossy
  stream's share of bytes stalls.
* Multiplexing (the paper's "multiplexing techniques"): n_streams parallel
  tensor streams fill the pipe during slow-start, modeled as bandwidth
  efficiency η(n_streams).

Constants are the usual WAN planning numbers; the model gives *relative*
protocol behaviour, not absolute WAN truth."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Link:
    """A cross-cloud WAN link."""
    latency_s: float = 0.03          # one-way
    bandwidth: float = 1.25e9        # bytes/s (10 Gbit/s leased line)
    loss_rate: float = 1e-4          # packet loss probability
    mss: int = 1400                  # bytes per packet


@dataclasses.dataclass(frozen=True)
class Protocol:
    name: str
    handshake_rtts: float            # connection setup round trips
    hol_blocking: bool               # loss stalls the whole connection?
    slow_start_eff: float            # bandwidth efficiency for one stream
    multiplex_gain: float            # how much extra streams recover

    def efficiency(self, n_streams: int) -> float:
        eff = self.slow_start_eff + self.multiplex_gain * (
            1.0 - math.exp(-(n_streams - 1) / 4.0)
        )
        return min(eff, 0.98)

    def transfer_time(
        self, nbytes: float, link: Link, n_streams: int = 4, reuse_conn: bool = True
    ) -> float:
        rtt = 2 * link.latency_s
        setup = 0.0 if reuse_conn else self.handshake_rtts * rtt
        wire = nbytes / (link.bandwidth * self.efficiency(n_streams))
        packets = nbytes / link.mss
        expected_losses = link.loss_rate * packets
        if self.hol_blocking:
            # every loss stalls all streams for ~1 RTT (retransmit turnaround)
            stall = expected_losses * rtt
        else:
            # loss isolated to one of n streams; only its share stalls
            stall = expected_losses * rtt / max(n_streams, 1)
        return setup + link.latency_s + wire + stall


TCP = Protocol("tcp", handshake_rtts=1.5, hol_blocking=True, slow_start_eff=0.60, multiplex_gain=0.0)
GRPC = Protocol("grpc", handshake_rtts=2.5, hol_blocking=True, slow_start_eff=0.65, multiplex_gain=0.25)
QUIC = Protocol("quic", handshake_rtts=0.0, hol_blocking=False, slow_start_eff=0.70, multiplex_gain=0.25)

PROTOCOLS = {p.name: p for p in (TCP, GRPC, QUIC)}


def sync_wall_time(
    nbytes_per_cloud: float,
    n_clouds: int,
    protocol: Protocol,
    link: Link,
    n_streams: int = 4,
    topology: str = "star",
) -> float:
    """One aggregation round's communication time.

    star: every cloud up+down to an aggregation point (parallel uplinks,
    bounded by the slowest); ring: 2(n−1)/n payload per hop, n−1 hops."""
    if topology == "star":
        up = protocol.transfer_time(nbytes_per_cloud, link, n_streams)
        down = protocol.transfer_time(nbytes_per_cloud, link, n_streams)
        return up + down
    if topology == "ring":
        chunk = nbytes_per_cloud / max(n_clouds, 1)
        hop = protocol.transfer_time(chunk, link, n_streams)
        return 2 * (n_clouds - 1) * hop
    raise ValueError(topology)
