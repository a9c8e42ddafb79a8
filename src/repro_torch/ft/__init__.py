from repro_torch.ft.health import (DeviceHealth, HealthReason, all_healthy,
                                   check_devices)
from repro_torch.ft.inject import Fault, FaultInjector, InjectedFault
from repro_torch.ft.integrity import (flip_bit, host_leaf_fingerprint,
                                      host_tree_fingerprint, leaf_fingerprint,
                                      region_fingerprints, tree_fingerprint)
from repro_torch.ft.straggler import StragglerMonitor
