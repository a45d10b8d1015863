"""SQL dialect: hand-written lexer + recursive-descent parser (copies of
the JAX package's sql/ modules).

GreptimeDB's dialect (src/sql/src/parser.rs upstream): CREATE TABLE with
TIME INDEX and tag PRIMARY KEY, range queries (ALIGN), TQL, flows,
SHOW/DESCRIBE/EXPLAIN, and the DML/DQL core. The port executes SELECT
only; the instance raises UnsupportedError on every other statement."""
