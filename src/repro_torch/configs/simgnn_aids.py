"""The paper's own model: SimGNN on AIDS — port of
`repro.configs.simgnn_aids`."""
from repro_torch.core.simgnn import SimGNNConfig

CONFIG = SimGNNConfig(n_node_labels=29, gcn_dims=(128, 64, 32), ntn_k=16,
                      fcn_dims=(8, 4), max_nodes=64)
