"""Streaming responses: incremental chunks from a deployment.

A deployment method that returns a *generator* streams automatically: the
replica pumps chunks through a bounded actor-backed queue
(`replica._start_stream`), the HTTP proxy renders them as
server-sent-events chunks, and Python callers unwrap with
``serve.iter_stream``. Reference role: ASGI StreamingResponse through the
uvicorn proxy (`serve/_private/http_proxy.py:425`); the transport here is
the object-plane queue, the contract — incremental chunks over one
request, first token before the last is computed — is the same.
"""

from __future__ import annotations

from typing import Any, Iterator

STREAM_KEY = "__ray_tpu_stream__"
STREAM_END_KEY = "__ray_tpu_stream_end__"


def is_stream(result: Any) -> bool:
    return isinstance(result, dict) and STREAM_KEY in result


def iter_stream(result: Any, timeout: float = 60.0) -> Iterator[Any]:
    """Iterate a streaming deployment response (pass-through for
    non-streaming results: yields the single value). The backing queue
    actor is torn down when the stream ends, errors, or the consumer
    abandons the iterator — the replica-side pump then unblocks on its
    put timeout and closes the generator."""
    if not is_stream(result):
        yield result
        return
    queue = result[STREAM_KEY]
    try:
        while True:
            item = queue.get(timeout=timeout)
            if isinstance(item, dict) and item.get(STREAM_END_KEY):
                error = item.get("error")
                if error:
                    raise RuntimeError(
                        f"stream failed in deployment: {error}")
                return
            yield item
    finally:
        try:
            queue.shutdown()
        except Exception:
            pass


async def aiter_stream(result: Any, timeout: float = 60.0):
    """Async counterpart of :func:`iter_stream` for event-loop consumers
    (the asyncio HTTP proxy): each chunk is awaited through the queue
    actor's ObjectRef, so a slow generator never blocks the loop other
    requests are running on. Same contract — pass-through for
    non-streaming results, queue torn down on exit."""
    if not is_stream(result):
        yield result
        return
    queue = result[STREAM_KEY]
    try:
        while True:
            ok, item = await queue.get_async(timeout)
            if not ok:
                raise TimeoutError(
                    f"no stream chunk within {timeout}s")
            if isinstance(item, dict) and item.get(STREAM_END_KEY):
                error = item.get("error")
                if error:
                    raise RuntimeError(
                        f"stream failed in deployment: {error}")
                return
            yield item
    finally:
        # Non-blocking teardown: the kill is a synchronous control
        # RPC, and this finally runs ON the proxy's event loop — the
        # blocking form would stall every other in-flight request
        # until the round-trip finished.
        try:
            queue.shutdown(block=False)
        except Exception:
            pass
