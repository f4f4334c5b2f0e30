"""Client filesystem API (Lustre Lite), port of `repro.fsio`.  The global
namespace (`repro.fsio.namespace`) is not ported yet."""
from repro_torch.fsio.client import (FileHandle, FsError,  # noqa: F401
                                     LustreClient)
