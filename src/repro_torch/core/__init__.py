"""DYNAMAP core: graph IR, cost model, PBQP mapping, DSE (paper §3-§5).

A copy of the reference planner (pure Python + numpy); only the import
paths differ, so plans compare one to one with ``repro.core``. The
autotuner (``core.autotune``) keeps the reference's record format and
measures on the device with torch."""
from repro_torch.core.algorithms import (Algorithm, AlgoFamily, DEFAULT_MENU,
                                         IM2COL, KN2ROW, Layout, PAPER_MENU,
                                         WINO_2_3, WINO_4_3, menu_for)
from repro_torch.core.cost_model import (ALL_DATAFLOWS, Dataflow, NodeCost,
                                         TPUSpec, TransitionCalibration, V5E,
                                         node_cost, transition_cost)
from repro_torch.core.dse import HardwareChoice, identify_parameters
from repro_torch.core.graph import ConvMeta, Graph, LayerKind, LayerNode
from repro_torch.core.autotune import (Binding, LayerTuning, TuningRecord,
                                       autotune_graph, benchmark_binding,
                                       candidate_bindings, conv_key,
                                       elision_overrides_from_meta,
                                       tune_elision, tune_layer)
from repro_torch.core.layouts import LayoutSpec, consumer_spec, invertible
from repro_torch.core.mapper import (ConvLowering, ExecutionPlan,
                                     LayoutTransition, LoweredProgram,
                                     lower_plan, map_network)
