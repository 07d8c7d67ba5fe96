from .client import BallistaClient
from .server import FlightServerHandle, ShuffleFlightService

__all__ = ["BallistaClient", "FlightServerHandle", "ShuffleFlightService"]
