"""The three benchmark twins' shared body: the harness's parser, the
JSON config, one ``BenchmarkRunner.run``."""

from __future__ import annotations

from rag_cobweb_tpu_torch.bench.harness import BenchmarkRunner
from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache


def run(dataset: str, description: str, argv=None, extra=()):
    """Parse ``argv`` with the harness's parser (the JAX scripts'
    arguments, with ``--device``), run ``dataset`` with the common
    arguments and those named in ``extra``, and return the runner (its
    rows in ``results``)."""
    enable_persistent_cache()
    parser = BenchmarkRunner.create_argument_parser(description)
    args = BenchmarkRunner.handle_config_and_args(parser.parse_args(argv))
    runner = BenchmarkRunner(dataset)
    runner.run(
        model_name=args.model_name, subset_size=args.subset_size,
        split=args.split, target_size=args.target_size, top_k=args.top_k,
        method=args.method, device=args.device,
        **{k: getattr(args, k) for k in extra})
    return runner
