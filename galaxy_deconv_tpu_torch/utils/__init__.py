from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict
from galaxy_deconv_tpu_torch.utils.device import resolve_device

__all__ = ["model_state_dict", "resolve_device"]
