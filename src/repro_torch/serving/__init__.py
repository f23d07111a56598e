from .allocator import AddressAllocationUnit
from .engine import ServeConfig, ServingEngine
from .scheduler import PAGE_TOKENS, Request, TwoLevelScheduler

__all__ = ["AddressAllocationUnit", "PAGE_TOKENS", "Request",
           "TwoLevelScheduler", "ServeConfig", "ServingEngine"]
