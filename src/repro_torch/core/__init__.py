"""DockerSSD core layer of the port: the paper's contribution as
composable modules (the counterparts of the names ``repro.core``
exports)."""
from repro_torch.core.container import (APP_REGISTRY, ContainerError,  # noqa: F401
                                        ContainerOOM, MiniDocker,
                                        from_jsonable, make_blob,
                                        ImageManifest, register_app,
                                        to_jsonable)
from repro_torch.core.ether_on import (DockerSSDEndpoint,  # noqa: F401
                                       EtherONDriver, EthernetFrame,
                                       UPCALL_SLOTS)
from repro_torch.core.extent_store import (ANALYTICS_IMAGE,  # noqa: F401
                                           AnalyticsJob, Extent,
                                           ExtentStore, ExtentStoreError,
                                           analytics_blob)
from repro_torch.core.kv_tier import (PagedKVCache, PageStore,  # noqa: F401
                                      PageTableManager)
from repro_torch.core.lambda_fs import (LambdaFS, LockHeld,  # noqa: F401
                                        PRIVATE_NS, SHARABLE_NS)
from repro_torch.core.storage_pool import (DockerSSDNode,  # noqa: F401
                                           NodeSpec, StoragePool)
from repro_torch.core.virtual_fw import (MPUViolation, TCPConn,  # noqa: F401
                                         VirtualFW)
