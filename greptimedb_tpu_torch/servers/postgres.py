"""The Postgres wire's type table (the JAX package's servers/postgres.py
PG_TYPES); pg_catalog.pg_type reads it. The wire protocol itself waits
for ROADMAP A3."""

# (typname, oid, typlen)
PG_TYPES = [
    ("bool", 16, 1), ("int8", 20, 8), ("text", 25, -1),
    ("float8", 701, 8), ("timestamp", 1114, 8), ("numeric", 1700, -1),
    ("varchar", 1043, -1), ("int4", 23, 4), ("float4", 700, 4),
]
