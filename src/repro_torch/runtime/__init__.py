"""Cluster runtime: heartbeats, ticket-age straggler detection, elastic
re-mesh planning."""

from .heartbeat import HeartbeatMonitor
from .straggler import StepTickets
from .elastic import remesh_plan

__all__ = ["HeartbeatMonitor", "StepTickets", "remesh_plan"]
