"""MoE ticket dispatch and routing plan: plain versions (``ref``), CUDA
kernel wrappers (``kernel``: the ticket kernel; ``plan``: the routing-plan
kernel) and the public ops (``ops``)."""

from .ops import (MODES, PLAN_MODES, assign_slots, aux_loss,
                  dispatch_combine_plan, route_plan)
from .ref import dispatch_ref, plan_ref, ticket_ref

__all__ = ["MODES", "PLAN_MODES", "assign_slots", "aux_loss",
           "dispatch_combine_plan", "dispatch_ref", "plan_ref", "route_plan",
           "ticket_ref"]
