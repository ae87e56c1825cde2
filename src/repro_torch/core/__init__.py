"""The RouteBalance scheduler and its baselines: scoring, admission, the
greedy scan and its staged backends, the hot path, the policies, the
serving engine and the cell driver."""
from .assignment import greedy_assign, greedy_assign_torch, hungarian, \
    lpt_order
from .budget import admission_mask, max_tokens_clamp
from .decision import decide_batch, greedy_core
from .dispatchers import DISPATCHERS, RandomDispatch, RoundRobin, \
    ShortestQueue
from .driver import make_requests, run_cell
from .engine import (AssignmentResult, BatchView, EngineConfig,
                     SchedulingPolicy, ServingEngine)
from .hotpath import FusedHotPath
from .pipeline import PipelineConfig, PipelineScheduler
from .policies import (POLICIES, RouterDispatchPolicy, fit_policy,
                       make_policy, register_policy, train_data)
from .routers import AvengersProRouter, BestRouteRouter, PassthroughRouter
from .scheduler import EstimatorBundle, RBConfig, RouteBalance, \
    RouteBalancePolicy
from .scoring import score_matrix, score_row
from .weights import PRESETS, sweep, validate

__all__ = ["AssignmentResult", "AvengersProRouter", "BatchView",
           "BestRouteRouter", "DISPATCHERS", "EngineConfig",
           "EstimatorBundle", "FusedHotPath", "POLICIES", "PRESETS",
           "PassthroughRouter", "PipelineConfig", "PipelineScheduler",
           "RBConfig", "RandomDispatch", "RoundRobin", "RouteBalance",
           "RouteBalancePolicy", "RouterDispatchPolicy", "SchedulingPolicy",
           "ServingEngine", "ShortestQueue", "admission_mask",
           "decide_batch", "fit_policy", "greedy_assign",
           "greedy_assign_torch", "greedy_core", "hungarian", "lpt_order",
           "make_policy", "make_requests", "max_tokens_clamp",
           "register_policy", "run_cell", "score_matrix", "score_row",
           "sweep", "train_data", "validate"]
