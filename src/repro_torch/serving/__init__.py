from repro_torch.serving.coordinator import (HostSegmentServer,
                                             QueryCoordinator,
                                             SegmentServer,
                                             attach_shared_fetch_queue,
                                             merge_topk)
from repro_torch.serving.batcher import RequestBatcher
from repro_torch.serving.router import MeshQueryRouter
from repro_torch.serving.scheduler import RepackDecision, RepackScheduler
from repro_torch.serving.target import SegmentTarget, is_target
