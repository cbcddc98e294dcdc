"""Store layer: directories, checksummed array files, locks.

Equivalent of the reference's store layer (``diagon/store/``, SURVEY.md
section 2.1) redesigned around the device data path: index artifacts are dense
numpy arrays in a checksummed container that memory-maps zero-copy
(``np.memmap``) and uploads to HBM unchanged — the mmap'd file IS the
device-ready format (reference: ``MMapDirectory.h`` zero-copy reads).
"""

from diagon_tpu.store.directory import (  # noqa: F401
    Directory,
    FSDirectory,
    RAMDirectory,
)
from diagon_tpu.store.format import (  # noqa: F401
    ArrayBundleReader,
    ArrayBundleWriter,
    read_segment,
    write_segment,
)
from diagon_tpu.store.lock import Lock, LockObtainFailedError  # noqa: F401
