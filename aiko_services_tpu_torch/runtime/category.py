"""Category: a Service that owns/manages a collection of Services.

The port's copy of ``aiko_services_tpu/runtime/category.py`` (it has no JAX
in it); its imports point at the port's own modules.

The reference leaves this as a 7-line stub (``main/category.py:1-7``)
noting only that "Registrar, ProcessManager, LifeCycleManager, Pipeline
are Categories".  Here the concept is made concrete as a small mixin so
those managers expose a uniform membership surface: remote tools can ask
any Category ``(category_list response_topic)`` and get the members
regardless of whether it's a pipeline listing its elements or a
lifecycle manager listing its clients.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["Category"]


class Category:
    """Mixin for services that manage a named collection of members.

    Members are records ``name -> info-dict`` (e.g. topic_path, state).
    Mix into an Actor and the ``category_list`` command becomes remotely
    invocable via the standard ``(command args)`` dispatch.

    Member storage is created lazily on first use, so the mixin composes
    with any ``__init__`` chain (Actor constructors take arguments and
    don't cooperatively chain here).
    """

    @property
    def _category_members(self) -> Dict[str, dict]:
        return self.__dict__.setdefault("_category_member_store", {})

    # -- membership ---------------------------------------------------

    def category_add(self, name: str, info: Optional[dict] = None) -> None:
        self._category_members[str(name)] = dict(info or {})

    def category_remove(self, name: str) -> Optional[dict]:
        return self._category_members.pop(str(name), None)

    def category_members(self) -> Dict[str, dict]:
        return dict(self._category_members)

    def __contains__(self, name) -> bool:
        return str(name) in self._category_members

    def __len__(self) -> int:
        return len(self._category_members)

    # -- remote query (request/response idiom, SURVEY §2.2 Storage) ---

    def category_list(self, response_topic: str) -> None:
        """Publish ``(item_count N)`` then one ``(member name info…)``
        per member to ``response_topic``."""
        publish = getattr(getattr(self, "process", None), "message", None)
        if publish is None:
            return
        from ..utils.sexpr import generate
        publish.publish(response_topic,
                        generate("item_count", [len(self._category_members)]))
        for name, info in self._category_members.items():
            fields = [name] + [f"{k}={v}" for k, v in info.items()]
            publish.publish(response_topic, generate("member", fields))
