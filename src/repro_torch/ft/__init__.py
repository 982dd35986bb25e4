# Fault tolerance (port of ``repro.ft``): step checkpoints that restore in
# either package, and heartbeat-based straggler detection.
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.straggler import HeartbeatMonitor, StragglerReport
