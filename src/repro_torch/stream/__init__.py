"""Stream substrate: generators, the fault-tolerant ingestion frontier,
and the chaos (fault-injection) harness."""

from repro_torch.stream.generator import (
    DisorderConfig,
    StreamConfig,
    disordered_sources,
    random_walk_query,
    split_stream,
    synth_social_stream,
    synth_traffic_stream,
)
from repro_torch.stream.ingest import (
    CallbackRegistry,
    IngestError,
    IngestFrontier,
    IngestStats,
    ListSource,
    MonotonicityError,
    ScriptedSource,
    SeqTracker,
    Source,
    SourceAdapter,
    SourceDisconnected,
    SourceEvent,
    merge_event_streams,
)
from repro_torch.stream.chaos import ChaosConfig, ChaosDisconnect, ChaosSource
