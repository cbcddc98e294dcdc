"""Columnar storage: typed columns, granules, skip indexes, scan kernels.

Equivalent of the reference's ClickHouse-style layer (SURVEY.md section 2.8:
``IColumn``/``ColumnVector`` hierarchy, 8192-row granules with marks,
minmax/bloom skip indexes, pluggable compression, and the ColumnarStore
used by ClickBench). Accelerator redesign: columns are dense arrays resident in
HBM; granule skip indexes are dense ``[n_granules]`` min/max and bloom
arrays so pruning is one vectorized comparison; scan/filter/aggregate are
masked whole-granule device kernels instead of per-row loops.
"""

from diagon_tpu.columnar.column import (  # noqa: F401
    Column,
    Float64Column,
    Int64Column,
    StringColumn,
    column_from_values,
)
from diagon_tpu.columnar.table import ColumnarTable, GRANULE_ROWS  # noqa: F401
from diagon_tpu.columnar.compression import (  # noqa: F401
    CODECS,
    compress,
    decompress,
)
from diagon_tpu.columnar.store import read_table, write_table  # noqa: F401
from diagon_tpu.columnar.engine import DeviceTable  # noqa: F401
from diagon_tpu.columnar.parts import (  # noqa: F401
    DataPart,
    DataPartState,
    DataPartType,
    delete_part,
    merge_parts,
    merge_tables,
    read_part,
    select_part_type,
    write_part,
)
