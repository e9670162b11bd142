"""MoE ticket dispatch: plain version (``ref``), CUDA kernel wrapper
(``kernel``) and the public ops (``ops``)."""

from .ops import MODES, assign_slots, dispatch_combine_plan
from .ref import dispatch_ref, ticket_ref

__all__ = ["MODES", "assign_slots", "dispatch_combine_plan", "dispatch_ref",
           "ticket_ref"]
