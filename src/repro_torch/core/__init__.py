"""Core P2HNNS library: tree, bounds, search schemes, oracle, index API,
and the two-round lambda exchange over shards (``distributed``)."""
from repro_torch.core.api import BuildReport, P2HIndex
from repro_torch.core.balltree import (
    FlatTree,
    append_ones,
    build_tree,
    normalize_query,
)
from repro_torch.core.distributed import two_round_exchange, warm_round1
from repro_torch.core.exact import exact_search, p2h_dists
from repro_torch.core.search import (
    SearchStats,
    beam_search,
    dfs_search,
    merge_topk,
    merge_topk_planes,
    sweep_search,
)
