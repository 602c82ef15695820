"""``aiko_pipeline`` CLI: create/destroy pipelines from JSON definitions.

The port's copy of ``aiko_services_tpu/pipeline/cli.py``: the same verbs
over the port's ``Pipeline``.

Reference parity: upstream aiko_services ``main/pipeline.py:
1565-1686`` (same verbs and flags).  ``create`` builds the pipeline in
this process and runs the event loop; ``--frame_data`` posts an initial
frame (S-expression dict, e.g. ``"(i: 1)"``), ``--frame_rate`` turns that
into a paced frame generator.  ``destroy`` finds the named pipeline via
the registrar and asks it to terminate.
"""

from __future__ import annotations

import sys

import click

from ..utils.sexpr import parse_tree
from ..runtime.context import pipeline_args, compose_instance
from ..runtime.process import default_process
from ..runtime.service import ServiceFilter
from .definition import load_pipeline_definition
from .pipeline import DEFAULT_GRACE_TIME, Pipeline
from .stream import DEFAULT_STREAM_ID, StreamEvent


@click.group()
def main():
    """Pipeline creation and control."""


@main.command(help="Create a pipeline from DEFINITION_PATHNAME (JSON)")
@click.argument("definition_pathname")
@click.option("--name", "-n", default=None, help="Pipeline service name")
@click.option("--graph_path", "-gp", default=None,
              help="Graph path (sub-graph head), 'local:remote' form")
@click.option("--stream_id", "-s", default=DEFAULT_STREAM_ID)
@click.option("--stream_parameters", "-sp", multiple=True, nargs=2,
              help="Stream parameter name/value pairs")
@click.option("--frame_data", "-fd", default=None,
              help='Initial frame as an S-expression dict: "(i: 1)"')
@click.option("--frame_count", "-fc", default=1, type=int,
              help="How many frames of --frame_data to post")
@click.option("--frame_rate", "-fr", default=0.0, type=float,
              help="Frames per second (0 = post immediately)")
@click.option("--grace_time", "-gt", default=DEFAULT_GRACE_TIME, type=float)
@click.option("--show_response", "-sr", is_flag=True,
              help="Print each completed frame's outputs")
@click.option("--no_stream", is_flag=True,
              help="Do not auto-create the default stream")
def create(definition_pathname, name, graph_path, stream_id,
           stream_parameters, frame_data, frame_count, frame_rate,
           grace_time, show_response, no_stream):
    definition = load_pipeline_definition(definition_pathname)
    process = default_process()
    pipeline = compose_instance(
        Pipeline,
        pipeline_args(name or definition.name, definition=definition,
                      definition_pathname=definition_pathname,
                      graph_path=graph_path),
        process=process)
    parameters = {k: v for k, v in stream_parameters}

    queue_response = None
    if show_response:
        import queue as queue_module
        queue_response = queue_module.Queue()

        def printer():
            while not queue_response.empty():
                _, frame, outputs = queue_response.get()
                click.echo(f"frame {frame.frame_id}: {outputs}")
        process.event.add_timer_handler(printer, 0.1)

    if not no_stream:
        pipeline.create_stream(stream_id, parameters=parameters,
                               graph_path=graph_path,
                               grace_time=grace_time,
                               queue_response=queue_response)
    if frame_data is not None:
        tree = parse_tree(frame_data)
        data = tree if isinstance(tree, dict) else {}
        if frame_rate:
            stream = pipeline.streams.get(str(stream_id))
            if stream is None:
                raise click.UsageError(
                    "--frame_rate needs a stream; drop --no_stream")
            def generator(stream_, frame_id):
                if frame_id >= frame_count:
                    return StreamEvent.STOP, None
                return StreamEvent.OKAY, dict(data)
            pipeline.create_frames(stream, generator, rate=frame_rate)
        else:
            for _ in range(frame_count):
                pipeline.post_frame(stream_id, dict(data))
    try:
        pipeline.run()
    except KeyboardInterrupt:  # pragma: no cover
        sys.exit(0)


@main.command(help="Destroy the named pipeline")
@click.argument("name")
def destroy(name):
    from ..registry.services_cache import services_cache_create_singleton
    process = default_process()
    cache = services_cache_create_singleton(process)

    def found(fields):
        process.message.publish(f"{fields.topic_path}/in", "(terminate)")
        click.echo(f"terminate -> {fields.topic_path}")
        process.event.terminate()

    cache.add_handler(ServiceFilter(name=name), found)
    process.event.add_timer_handler(
        lambda: (click.echo("not found"), process.event.terminate()),
        5.0, once=True)
    process.run()


if __name__ == "__main__":
    main()
