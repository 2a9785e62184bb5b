"""CNN substrate: Computing Unit overlay, executable layers, model-graph
builders, eager executor + plan compiler."""
from repro_torch.cnn.executor import (ExecutableCache, compile_plan, forward,
                                      graph_hash, init_params)
from repro_torch.cnn.models import (MODELS, alexnet, googlenet, inception_v4,
                                    resnet18, vgg16)
from repro_torch.cnn.overlay import apply_conv
