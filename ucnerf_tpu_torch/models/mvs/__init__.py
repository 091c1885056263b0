from ucnerf_tpu_torch.models.mvs.extractor import BasicEncoder
from ucnerf_tpu_torch.models.mvs.raft import RAFTMVS
