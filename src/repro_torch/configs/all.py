"""Import side-effect module: registers every architecture of the JAX
package, in its order.  Registering an arch does not make its family
buildable: ``models.model.Model`` raises ``NotImplementedError`` for a
family the port does not have yet."""
import repro_torch.configs.qwen2_moe_a2_7b   # noqa: F401
import repro_torch.configs.arctic_480b       # noqa: F401
import repro_torch.configs.granite_8b        # noqa: F401
import repro_torch.configs.tinyllama_1_1b    # noqa: F401
import repro_torch.configs.qwen3_32b         # noqa: F401
import repro_torch.configs.mistral_nemo_12b  # noqa: F401
import repro_torch.configs.zamba2_2_7b       # noqa: F401
import repro_torch.configs.qwen2_vl_7b       # noqa: F401
import repro_torch.configs.xlstm_350m        # noqa: F401
import repro_torch.configs.seamless_m4t_medium  # noqa: F401
