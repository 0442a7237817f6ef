from galaxy_deconv_tpu_torch.utils.convert_flax import unrolled_admm_gaussian_state_dict
from galaxy_deconv_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device", "unrolled_admm_gaussian_state_dict"]
