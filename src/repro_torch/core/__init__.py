"""The port's engines: graphs, signal models, threefry PRNG, sparse
push-sum, Algorithm 3 social learning and Algorithm 2 Byzantine-resilient
learning."""
from . import attacks
from .byzantine import (
    ByzantineConfig,
    ByzantineResult,
    ByzRuntime,
    byzantine_runtime_from_edge_list,
    decide,
    healthy_networks,
    make_byzantine_runtime,
    make_byzantine_scan,
    run_byzantine_learning,
    run_byzantine_learning_ovr,
    run_byzantine_runtime,
)
from .graphs import (
    EdgeList,
    HierTopology,
    block_complete_edge_list,
    edge_list,
    hier_edge_list,
    make_hierarchy,
    neighbor_lists,
    sort_by_dst,
)
from .hps import HPSConfig, hps_fusion, ps_trimmed_pool
from .plan import ExecutionPlan, resolve_device
from .pushsum import (
    SparsePushSumState,
    init_sparse_state,
    sparse_mass_invariant,
    sparse_pushsum_step,
    sparse_ratios,
    step_edge_mask,
)
from .signals import SignalModel, make_confused_model
from .social import (
    SocialLearningResult,
    SocialRuntime,
    make_social_runtime,
    run_social_learning,
    run_social_runtime,
    social_runtime_from_edge_list,
    theorem2_rate,
)

__all__ = [
    "attacks", "ByzantineConfig", "ByzantineResult", "ByzRuntime",
    "byzantine_runtime_from_edge_list", "decide", "healthy_networks",
    "make_byzantine_runtime", "make_byzantine_scan", "run_byzantine_learning",
    "run_byzantine_learning_ovr", "run_byzantine_runtime",
    "EdgeList", "HierTopology", "block_complete_edge_list", "edge_list",
    "hier_edge_list", "make_hierarchy", "neighbor_lists", "sort_by_dst",
    "HPSConfig", "hps_fusion", "ps_trimmed_pool",
    "ExecutionPlan", "resolve_device",
    "SparsePushSumState", "init_sparse_state", "sparse_mass_invariant",
    "sparse_pushsum_step", "sparse_ratios", "step_edge_mask",
    "SignalModel", "make_confused_model",
    "SocialLearningResult", "SocialRuntime", "make_social_runtime",
    "run_social_learning", "run_social_runtime",
    "social_runtime_from_edge_list", "theorem2_rate",
]
