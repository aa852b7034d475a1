"""Core: the paper's contribution — A-SRPT scheduling for DDLwMP jobs.

The port's copy of the JAX package's ``repro/core``: numpy on the host,
module for module the reference's code, so that it gives the reference's
schedules bit for bit (the golden sha256s, the ``--serve`` regime's
digests).  The one import that leaves the package, ``scenario.py``'s
``..serve.latency``, resolves to the port's ``serve/latency.py``, which
holds its own copy of ``DEFAULT_SERVE_MODEL``.  The code is the
reference's but for the program name of ``scenario.py``'s command line;
comments and docstrings leave out the reference's development history,
and their ``repro.core`` names are the reference's modules, which these
copy.  The device enters through the serving replicas' latency curve (``RequestStream.svc_base`` and
``svc_per_req``), which ``repro_torch.serve.latency.calibrate`` measures.

Not copied yet: ``fleet.py`` (batched Monte-Carlo variants),
``trace_ingest.py`` (public trace CSVs) and ``ilp.py`` (the exact
min-cut check).
"""
from .job import (  # noqa: F401
    ClusterSpec,
    JobSpec,
    RAR,
    ServerClass,
    StageSpec,
    TAR,
)
from .graph import JobGraph, build_job_graph  # noqa: F401
from .timing import alpha, alpha_max, beta  # noqa: F401
from .heavy_edge import (  # noqa: F401
    alpha_min_estimate,
    map_job,
    select_servers,
)
from .cluster import ClusterState  # noqa: F401
from .srpt import VirtualSRPT, srpt_total_completion  # noqa: F401
from .scenario import (  # noqa: F401
    ArrivalJitterPerturbation,
    ClusterEvent,
    Degradation,
    ElasticPerturbation,
    Fault,
    FaultPerturbation,
    IterJobs,
    JobStream,
    JsonlJobs,
    Perturbation,
    PredictionNoisePerturbation,
    REQUEST_STREAM_KIND,
    RequestStream,
    SCENARIO_SCHEMA_VERSION,
    Scenario,
    ServerJoin,
    ServerLeave,
    StragglerPerturbation,
    jobs_to_jsonl,
    perturb_scenario,
    request_stream_from_dict,
    request_stream_to_dict,
    scenario_from_legacy,
)
from .simulator import (  # noqa: F401
    Allocation,
    Migration,
    Policy,
    SERVE_LAT_QUANTILES,
    STREAM_FLOW_QUANTILES,
    SchedulingPolicy,
    SimResult,
    Start,
    simulate,
)
from .quantile import StreamingQuantile  # noqa: F401
from .migration import MIGRATION_PENALTY_DEFAULT, MigrationMixin  # noqa: F401
from .asrpt import ASRPTPolicy  # noqa: F401
from .baselines import BASELINES  # noqa: F401
from .predictor import (  # noqa: F401
    GroupStatPredictor,
    IterationPredictor,
    PerfectPredictor,
    RandomForestPredictor,
    RandomForestRegressor,
    make_predictor,
)
from .prediction_loop import (  # noqa: F401
    NoisyModel,
    OnlineForestModel,
    OracleModel,
    PredictionModel,
    ZeroColdStartModel,
    make_prediction_model,
)
from .trace import (  # noqa: F401
    StreamTraceConfig,
    TraceConfig,
    elastic_events,
    elastic_scenario,
    generate_trace,
    mixed_cluster_spec,
    straggler_events,
    straggler_scenario,
    stream_trace,
    stream_trace_source,
    trace_stats,
)
from .profiles import PAPER_MODELS, make_job, job_from_model_shape  # noqa: F401
