"""The RouteBalance scheduler: scoring, admission, the greedy scan, the
hot path, the serving engine and the cell driver."""
from .driver import make_requests, run_cell
from .engine import (AssignmentResult, BatchView, EngineConfig,
                     SchedulingPolicy, ServingEngine)
from .scheduler import (EstimatorBundle, RBConfig, RouteBalance,
                        RouteBalancePolicy)
from .weights import PRESETS, validate

__all__ = ["AssignmentResult", "BatchView", "EngineConfig",
           "EstimatorBundle", "PRESETS", "RBConfig", "RouteBalance",
           "RouteBalancePolicy", "SchedulingPolicy", "ServingEngine",
           "make_requests", "run_cell", "validate"]
