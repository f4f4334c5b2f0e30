"""Client filesystem API (Lustre Lite) + global namespace (ch. 3)."""
from repro_torch.fsio.client import LustreClient, FsError, FileHandle  # noqa: F401
from repro_torch.fsio.namespace import (Automounter, GlobalNamespace,  # noqa: F401
                                  make_mount_object)
