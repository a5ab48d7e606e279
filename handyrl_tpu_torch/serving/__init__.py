"""The serving tier of the port: a versioned model registry
(:mod:`.registry`), the InferenceService process (:mod:`.service`, run as
``python -m handyrl_tpu_torch.serving``) and its client (:mod:`.client`).
The wire protocol and the registry's manifest format are the JAX
package's, so clients and registries of either package interoperate.
"""
