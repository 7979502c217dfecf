"""The paper's own evaluation workloads (S6, Table 3) as configs.

Not an LM arch: these parameterize the PULSE engine benchmarks (WebService
hash table, WiredTiger B+tree range queries, BTrDB time-series aggregation)
with the paper's dataset shapes and the prototype's hardware constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PulseWorkload:
    name: str
    structure: str  # hash | btree_find | btree_range
    n_keys: int
    n_buckets: int = 0
    value_bytes: int = 8
    expected_tc_td: float = 0.0  # paper Table 3
    expected_iters: tuple = ()  # paper Table 3
    zipf_s: float = 0.99  # YCSB zipfian skew


WEBSERVICE = PulseWorkload(
    name="webservice",
    structure="hash",
    n_keys=200_000,
    n_buckets=4096,  # long chains: ~48 iterations/request (Table 3)
    expected_tc_td=0.06,
    expected_iters=(48,),
)

WIREDTIGER = PulseWorkload(
    name="wiredtiger",
    structure="btree_find",
    n_keys=500_000,
    expected_tc_td=0.63,
    expected_iters=(25,),
)

BTRDB = PulseWorkload(
    name="btrdb",
    structure="btree_range",
    n_keys=500_000,
    expected_tc_td=0.71,
    expected_iters=(38, 227),  # 1 s .. 8 s windows
)

WORKLOADS = {w.name: w for w in (WEBSERVICE, WIREDTIGER, BTRDB)}

# prototype constants (S6 setup)
MEM_BW_GBPS = 25.0
MEM_NODES = 4
ETA = 0.75  # m=3 logic : n=4 memory pipelines
CONFIG = None  # not an LM arch; see WORKLOADS
