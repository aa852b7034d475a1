"""DNN workload profiles and JobSpec construction.

Two sources of stage profiles:

1. The paper's nine profiled models (Table I).  We cannot profile real
   V100/H100 GPUs offline, so the per-model single-device iteration time,
   parameter bytes, and boundary activation bytes are *analytic* estimates
   (FLOPs / effective throughput; params x 4 B; batch x seq x hidden x 4 B),
   which is exactly the information the paper's timing model consumes.
2. A bridge from this framework's own architecture configs
   (``repro/configs``): any of the 10 assigned architectures can be turned
   into a DDLwMP job with a pipeline split, so the scheduler schedules the
   same models the data plane trains (see ``job_from_model_shape``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .job import JobSpec, StageSpec, RAR

MB = 1024.0**2
GB = 1024.0**3


@dataclass(frozen=True)
class ModelProfile:
    """Per-model analytic profile at the paper's mini-batch size."""

    name: str
    params_bytes: float  # trainable bytes (fp32)
    iter_time_1dev: float  # p_f + p_b of the whole model on one device (s)
    act_bytes: float  # activation bytes at a stage boundary (d_out)
    configs: Tuple[Tuple[int, ...], ...]  # per-stage replica counts options


# Paper Table I, with distributed configurations in the spirit of the
# pipeline planner of [20]: a mix of DP (single stage, many replicas),
# MP (many stages, 1 replica) and PP (stages with varying replication).
PAPER_MODELS: Dict[str, ModelProfile] = {
    "vgg19": ModelProfile(
        "vgg19", 144e6 * 4, 0.40, 20 * MB,
        ((1,), (2,), (4,), (8,), (2, 2), (4, 4)),
    ),
    "resnet152": ModelProfile(
        "resnet152", 60e6 * 4, 0.05, 3 * MB,
        ((1,), (2,), (4,), (8,), (2, 2)),
    ),
    "inception_v3": ModelProfile(
        "inception_v3", 24e6 * 4, 0.12, 8 * MB,
        ((1,), (2,), (4,), (8,)),
    ),
    "bert_large": ModelProfile(
        "bert_large", 340e6 * 4, 0.30, 6 * MB,
        ((1,), (2,), (4,), (2, 2), (4, 4)),
    ),
    "xlnet_large": ModelProfile(
        "xlnet_large", 550e6 * 4, 0.45, 6 * MB,
        ((1,), (2,), (4,), (2, 2), (4, 4)),
    ),
    # T5 / GPT entries are the paper's 3-layer profiling slices.
    "t5": ModelProfile(
        "t5", 1.4e9 * 4, 0.35, 17 * MB,
        ((1, 1), (2, 2), (1, 1, 1, 1), (2, 2, 2, 2), (4, 4)),
    ),
    "gpt_6.7b": ModelProfile(
        "gpt_6.7b", 0.63e9 * 4, 4.0, 268 * MB,
        ((1, 1), (2, 2), (1, 1, 1, 1), (2, 2, 2, 2)),
    ),
    "gpt_13b": ModelProfile(
        "gpt_13b", 1.2e9 * 4, 8.0, 335 * MB,
        ((1, 1), (2, 2), (1, 1, 1, 1), (2, 2, 2, 2), (4, 4, 4, 4)),
    ),
    "gpt_175b": ModelProfile(
        "gpt_175b", 5.4e9 * 4, 20.0, 402 * MB,
        ((1, 1, 1, 1), (2, 2, 2, 2), (1,) * 8, (2,) * 8, (4,) * 8),
    ),
}

SINGLE_GPU_MODELS = [
    "vgg19", "resnet152", "inception_v3", "bert_large", "xlnet_large",
]


def build_stages(
    profile: ModelProfile, replicas: Sequence[int]
) -> Tuple[StageSpec, ...]:
    """Split a model profile uniformly into len(replicas) pipeline stages."""
    S = len(replicas)
    stage_time = profile.iter_time_1dev / S
    h = profile.params_bytes / S
    stages: List[StageSpec] = []
    for s, k in enumerate(replicas):
        d_out = profile.act_bytes if s < S - 1 else 0.0
        if s > 0:
            # Consistency: k_{s-1} * d_out_{s-1} == k_s * d_in_s.
            d_in = replicas[s - 1] * profile.act_bytes / k
        else:
            d_in = 0.0
        stages.append(
            StageSpec(
                p_f=stage_time / 3.0,
                p_b=2.0 * stage_time / 3.0,
                d_in=d_in,
                d_out=d_out,
                h=h,
                k=int(k),
            )
        )
    return tuple(stages)


def make_job(
    job_id: int,
    model: str,
    config_idx: int,
    n_iters: int,
    arrival: float = 0.0,
    group_id: int = -1,
    user_id: int = 0,
    allreduce: str = RAR,
) -> JobSpec:
    profile = PAPER_MODELS[model]
    replicas = profile.configs[config_idx % len(profile.configs)]
    return JobSpec(
        job_id=job_id,
        stages=build_stages(profile, replicas),
        n_iters=n_iters,
        arrival=arrival,
        group_id=group_id,
        user_id=user_id,
        allreduce=allreduce,
        model_name=model,
    )


def job_from_model_shape(
    job_id: int,
    name: str,
    total_params: float,
    d_model: int,
    global_batch: int,
    seq_len: int,
    replicas: Sequence[int],
    n_iters: int,
    arrival: float = 0.0,
    group_id: int = -1,
    user_id: int = 0,
    allreduce: str = RAR,
    peak_flops: float = 197e12,
    mfu: float = 0.4,
    param_bytes: int = 2,  # bf16 on TPU
) -> JobSpec:
    """Bridge: one of this framework's architectures -> a DDLwMP job.

    Per-stage compute time = 6 * N_stage * tokens / (mfu * peak);
    boundary activations = batch * seq * d_model * param_bytes.
    """
    tokens = global_batch * seq_len
    S = len(replicas)
    n_stage = total_params / S
    stage_time = 6.0 * n_stage * tokens / (mfu * peak_flops)
    act = float(global_batch) * seq_len * d_model * param_bytes
    stages: List[StageSpec] = []
    for s, k in enumerate(replicas):
        d_out = act if s < S - 1 else 0.0
        d_in = replicas[s - 1] * act / k if s > 0 else 0.0
        stages.append(
            StageSpec(
                p_f=stage_time / 3.0,
                p_b=2.0 * stage_time / 3.0,
                d_in=d_in,
                d_out=d_out,
                h=n_stage * param_bytes,
                k=int(k),
            )
        )
    return JobSpec(
        job_id=job_id,
        stages=tuple(stages),
        n_iters=n_iters,
        arrival=arrival,
        group_id=group_id,
        user_id=user_id,
        allreduce=allreduce,
        model_name=name,
    )
