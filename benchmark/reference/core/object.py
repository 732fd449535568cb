"""Object base class (counterpart of ``psdr_jit_tpu/core/object.py``,
reference include/psdr/object.h:6-24).

Every scene object of the reference carries ``type_name``, ``to_string``,
an ``m_id`` string and a ``log`` helper. Concrete classes keep their id in
the plain ``id`` attribute (the param-map key); ``m_id`` aliases it.
"""

from __future__ import annotations


class Object:
    """Common base of Mesh, BSDF, Emitter, Sensor, Scene and Integrator."""

    id: str = ""

    def type_name(self) -> str:
        return type(self).__name__

    @property
    def m_id(self) -> str:
        return self.id

    @m_id.setter
    def m_id(self, value: str):
        self.id = value

    def to_string(self) -> str:
        return self.type_name()

    def __repr__(self) -> str:
        return self.to_string()

    def log(self, msg: str, level: int = 0):
        """The reference's Object::log (object.h:12-14): a print prefixed
        with the class name where ``level`` > 0."""
        if level > 0:
            print(f"[{self.type_name()}] {msg}")
