from .guest_api import GuestContext, GuestResult, run_guest
from .registry import CIRCUITS, CircuitSpec, get_circuit
