"""DWARF unwind-table pipeline (reference pkg/stack/unwind, layer L3).

The port's copy of parca_agent_tpu's unwind/__init__.py.
"""

from parca_agent_tpu_torch.unwind.table import (
    CFA_EXPR_PLT1,
    CFA_EXPR_PLT2,
    CFA_TYPE_EXPRESSION,
    CFA_TYPE_RBP,
    CFA_TYPE_RSP,
    RBP_TYPE_OFFSET,
    RBP_TYPE_REGISTER,
    RBP_TYPE_UNDEFINED,
    ROW_DTYPE,
    ShardedTable,
    UnwindTableBuilder,
    build_compact_table,
    identify_expression,
    lookup_rows,
    shard_table,
)

__all__ = [
    "CFA_EXPR_PLT1", "CFA_EXPR_PLT2", "CFA_TYPE_EXPRESSION", "CFA_TYPE_RBP",
    "CFA_TYPE_RSP", "RBP_TYPE_OFFSET", "RBP_TYPE_REGISTER",
    "RBP_TYPE_UNDEFINED", "ROW_DTYPE", "ShardedTable", "UnwindTableBuilder",
    "build_compact_table", "identify_expression", "lookup_rows", "shard_table",
]
