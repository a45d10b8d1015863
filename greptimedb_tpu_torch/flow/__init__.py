from greptimedb_tpu_torch.flow.manager import FlowManager

__all__ = ["FlowManager"]
