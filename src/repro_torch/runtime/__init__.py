"""The CIM inference engine and the compiled-program serving API."""
