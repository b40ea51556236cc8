from fms_fsdp_tpu_torch.config.training import TrainConfig

# Alias matching the reference's lowercase dataclass name
train_config = TrainConfig

__all__ = ["TrainConfig", "train_config"]
