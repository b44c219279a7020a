"""Model and data parallelism of the port over ``torch.distributed``
(mirrors ``sheeprl_tpu/parallel``): the (data, model) mesh, a rank
launcher, and the autograd-aware collectives of the model-sharded RSSM
step."""
